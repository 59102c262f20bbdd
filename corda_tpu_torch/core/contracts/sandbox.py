"""Deterministic sandbox for contract verification code.

Reference parity: experimental/sandbox — the prototype deterministic JVM
sandbox for contract code (WhitelistClassLoader.java:1-356: whitelist class
loading + ASM bytecode rewriting; visitors/CostInstrumentingMethodVisitor +
costing/RuntimeCostAccounter: runtime cost accounting that kills runaway
code). This package's contract bodies are Python, so the same two defenses
become:

- **Whitelist validation** (the WhitelistClassLoader role): contract source
  is parsed to an AST and rejected unless every construct is on the
  whitelist — no imports outside the allowed set, no dunder/underscore
  attribute access, no global/nonlocal, no async, no set displays (string
  hashing is process-seeded, so set iteration order is nondeterministic),
  and execution sees only a curated builtins table (no eval/exec/open/
  getattr/globals/hash/id/print...).
- **Cost accounting** (the CostInstrumentingMethodVisitor role): the AST is
  rewritten before compilation so every statement charges the instruction
  budget and every loop/comprehension iterates through a charging iterator;
  exhausting the budget raises SandboxCostExceeded mid-flight, exactly like
  the reference's TerminateException on runtime-cost thresholds.

Determinism, not security isolation, is the goal (same stance as the
reference prototype): the sandbox guarantees that a contract either
produces the same verdict on every node or dies the same way on every node.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass


class SandboxViolation(Exception):
    """Contract source uses a construct outside the deterministic whitelist."""


class SandboxCostExceeded(BaseException):
    """The in-flight budget kill raised inside sandboxed frames.

    Derives from BaseException (not Exception) so sandboxed ``except
    Exception`` handlers cannot swallow it — the budget kill must always
    propagate out of the contract, mirroring the reference's
    ThreadDeath-style TerminateException which user code cannot catch.
    At the sandbox boundary (``load``/``run``) it is rewrapped into
    :class:`SandboxBudgetError` so HOST code keeps ordinary
    ``except Exception`` semantics (a budget-killed contract becomes a
    normal verification failure, not a worker-killing BaseException)."""


class SandboxBudgetError(Exception):
    """Host-facing form of a budget kill, raised by ``load``/``run``."""


_SAFE_BUILTIN_NAMES = (
    "abs", "all", "any", "bool", "bytes", "chr", "dict", "divmod",
    "enumerate", "filter", "float", "format", "int", "isinstance",
    "issubclass", "iter", "len", "list", "map", "max", "min", "next", "ord",
    "pow", "range", "repr", "reversed", "round", "slice", "sorted", "str",
    "sum", "tuple", "zip",
    # exceptions contract code may raise/catch
    "Exception", "ValueError", "TypeError", "ArithmeticError",
    "AssertionError", "ZeroDivisionError", "StopIteration", "IndexError",
    "KeyError",
)

_BANNED_NODES = {
    ast.Import: "import",
    ast.ImportFrom: "import",
    ast.Global: "global",
    ast.Nonlocal: "nonlocal",
    ast.AsyncFunctionDef: "async def",
    ast.AsyncFor: "async for",
    ast.AsyncWith: "async with",
    ast.Await: "await",
    ast.Set: "set display (hash-order nondeterminism)",
    ast.SetComp: "set comprehension (hash-order nondeterminism)",
    ast.With: "with",
    # match-statement capture patterns (MatchAs.name / MatchStar.name /
    # MatchMapping.rest) carry raw string binding names that the ast.Name
    # underscore ban never sees — `match int:\n case _sandbox_charge: pass`
    # would rebind the injected charge hook and neutralize the budget
    # (ADVICE r2 high). Ban the whole statement, consistent with the
    # minimal deterministic whitelist.
    ast.Match: "match statement",
}

# String methods whose one-call output size is set by an integer width
# argument (ADVICE r2 medium: 'a'.ljust(200_000_000) allocates 200 MB for
# ~2 charged units), plus the .format/.format_map methods whose spec string
# smuggles the same width ('{:>200000000}'.format(1)). Banned outright;
# contract code uses the guarded format() builtin instead.
_WIDTH_METHODS = frozenset({
    "ljust", "rjust", "center", "zfill", "expandtabs",
    "format", "format_map",
})

# Largest width a format spec / %-format may request: big enough for any
# honest tabular output, far below an allocation attack.
_MAX_FORMAT_WIDTH = 10_000
_MAX_WIDTH_DIGITS = len(str(_MAX_FORMAT_WIDTH))

# %-format conversion specs: width/precision groups only — literal digits in
# the template text ("block 20260730: %d") are NOT padding and must not count.
_PERCENT_SPEC = re.compile(
    r"%(?:\([^)]*\))?[-+ #0]*(\*|\d+)?(?:\.(\*|\d+))?[hlL]*"
    r"[diouxXeEfFgGcrsab%]")


def _spec_width(spec: str) -> int:
    """Total of the integer runs in a format()/f-string spec string — an
    upper bound on the padding it can demand. Runs longer than the cap's
    digit count are reported as over-cap WITHOUT calling int() (CPython's
    int-to-str digit limit raises ValueError past 4300 digits, and that
    limit is per-process configurable — a determinism hazard)."""
    total = 0
    for run in re.findall(r"\d+", spec):
        if len(run) > _MAX_WIDTH_DIGITS:
            return _MAX_FORMAT_WIDTH + 1
        total += int(run)
    return total


def _percent_width(template: str) -> int:
    """Upper bound on the padding a %-format template demands, scanning
    only the width/precision of actual conversion specs. A ``*`` width
    (taken from the argument tuple at runtime) cannot be priced statically
    and is refused."""
    total = 0
    for width, precision in _PERCENT_SPEC.findall(template):
        for part in (width, precision):
            if part == "*":
                raise SandboxCostExceeded(
                    "dynamic '*' width in %-formatting is not allowed")
            if part:
                if len(part) > _MAX_WIDTH_DIGITS:
                    return _MAX_FORMAT_WIDTH + 1
                total += int(part)
    return total


def validate(source: str) -> ast.Module:
    """Parse + whitelist-check contract source; returns the AST."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        raise SandboxViolation(f"syntax error: {e}") from e
    for node in ast.walk(tree):
        for banned, label in _BANNED_NODES.items():
            if isinstance(node, banned):
                raise SandboxViolation(
                    f"line {getattr(node, 'lineno', '?')}: {label} "
                    f"is not allowed in sandboxed contract code")
        if isinstance(node, ast.Attribute) and node.attr.startswith("_"):
            raise SandboxViolation(
                f"line {node.lineno}: access to underscore attribute "
                f"{node.attr!r} is not allowed")
        if isinstance(node, ast.Attribute) and node.attr in _WIDTH_METHODS:
            raise SandboxViolation(
                f"line {node.lineno}: {node.attr!r} is not allowed in "
                f"sandboxed contract code (unbounded-width formatting; "
                f"use the format() builtin)")
        # f-string format specs are the same width surface as format():
        # reject dynamic specs and oversized constant widths up front.
        if isinstance(node, ast.FormattedValue) and \
                node.format_spec is not None:
            parts = []
            for piece in node.format_spec.values:
                if not isinstance(piece, ast.Constant):
                    raise SandboxViolation(
                        f"line {node.lineno}: dynamic f-string format "
                        f"spec is not allowed")
                parts.append(str(piece.value))
            if _spec_width("".join(parts)) > _MAX_FORMAT_WIDTH:
                raise SandboxViolation(
                    f"line {node.lineno}: f-string format width exceeds "
                    f"{_MAX_FORMAT_WIDTH}")
        # ANY underscore-prefixed name is banned (not just dunders): the
        # cost-accounting hooks are injected under single-underscore names
        # after validation, so user source must never be able to name (and
        # thus rebind or shadow) them.
        if isinstance(node, ast.Name) and node.id.startswith("_"):
            raise SandboxViolation(
                f"line {node.lineno}: underscore name {node.id!r} "
                f"is not allowed")
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                node.name.startswith("_"):
            raise SandboxViolation(
                f"line {node.lineno}: underscore name {node.name!r} "
                f"is not allowed")
        if isinstance(node, ast.arg) and node.arg.startswith("_"):
            raise SandboxViolation(
                f"line {node.lineno}: underscore argument {node.arg!r} "
                f"is not allowed")
        if isinstance(node, ast.keyword) and node.arg and \
                node.arg.startswith("_"):
            raise SandboxViolation(
                f"line {node.lineno}: underscore keyword {node.arg!r} "
                f"is not allowed")
        # bare `except:` catches BaseException and could swallow the budget
        # kill; require an explicit (whitelisted, Exception-derived) type.
        if isinstance(node, ast.ExceptHandler):
            if node.type is None:
                raise SandboxViolation(
                    f"line {node.lineno}: bare except is not allowed")
            if node.name and node.name.startswith("_"):
                raise SandboxViolation(
                    f"line {node.lineno}: underscore name {node.name!r} "
                    f"is not allowed")
    return tree


def _as_load(target: ast.expr) -> ast.expr:
    """Deep-copy a Store-context assignment target as a Load expression."""
    copied = ast.parse(ast.unparse(target), mode="eval").body
    return copied


class _CostTransformer(ast.NodeTransformer):
    """Rewrite so execution charges the budget: a __charge__() call before
    every statement, and every for/comprehension iterable wrapped in the
    charging iterator (per-iteration accounting, the per-instruction
    accounting analog)."""

    CHARGE = "_sandbox_charge"
    ITER = "_sandbox_iter"
    BINOP = "_sandbox_binop"

    # operators whose single-statement cost can be unbounded (10**10**8,
    # 'a' * 10**9, 1 << 10**9, repeated s = s + s doubling): routed through
    # a guarded helper that prices the result size against the budget
    # before evaluating.
    _GUARDED_OPS = {ast.Pow: "**", ast.Mult: "*", ast.LShift: "<<",
                    ast.Add: "+", ast.Mod: "%"}

    def visit_BinOp(self, node):
        node = self.generic_visit(node)
        label = self._GUARDED_OPS.get(type(node.op))
        if label is None:
            return node
        return ast.copy_location(ast.Call(
            ast.Name(self.BINOP, ast.Load()),
            [ast.Constant(label), node.left, node.right], []), node)

    def _charge_stmt(self, at) -> ast.Expr:
        return ast.copy_location(ast.Expr(ast.Call(
            ast.Name(self.CHARGE, ast.Load()), [], [])), at)

    def _rewrite_body(self, body: list) -> list:
        out = []
        for stmt in body:
            stmt = self.visit(stmt)
            out.append(self._charge_stmt(stmt))
            out.append(stmt)
        return out

    def visit_Module(self, node):
        node.body = self._rewrite_body(node.body)
        return node

    def visit_FunctionDef(self, node):
        # default-argument and decorator expressions execute at def time —
        # they need the binop guards too, not just the body
        node.args = self.generic_visit(node.args)
        node.decorator_list = [self.visit(d) for d in node.decorator_list]
        node.body = self._rewrite_body(node.body)
        return node

    def visit_AugAssign(self, node):
        # `x **= y` etc. must route through the same guard: desugar to
        # `x = _sandbox_binop("**=", x, y)`. The "=" suffix makes the
        # helper use the IN-PLACE operator (operator.ipow/imul/...), so
        # `b += [2]` still mutates an aliased list exactly as Python does
        # (re-evaluating a subscript/attribute target is acceptable inside
        # the deterministic whitelist).
        if type(node.op) not in self._GUARDED_OPS:
            return self.generic_visit(node)
        label = self._GUARDED_OPS[type(node.op)] + "="
        load_target = ast.copy_location(ast.fix_missing_locations(
            _as_load(node.target)), node.target)
        call = ast.copy_location(ast.Call(
            ast.Name(self.BINOP, ast.Load()),
            [ast.Constant(label), load_target, self.visit(node.value)], []),
            node)
        return ast.copy_location(
            ast.Assign(targets=[node.target], value=call), node)

    def visit_For(self, node):
        node.iter = ast.copy_location(ast.Call(
            ast.Name(self.ITER, ast.Load()), [self.visit(node.iter)], []),
            node.iter)
        node.body = self._rewrite_body(node.body)
        node.orelse = self._rewrite_body(node.orelse)
        return node

    def visit_While(self, node):
        node.test = self.visit(node.test)
        node.body = self._rewrite_body(node.body)
        node.orelse = self._rewrite_body(node.orelse)
        return node

    def _wrap_comp(self, node):
        node = self.generic_visit(node)
        for gen in node.generators:
            gen.iter = ast.copy_location(ast.Call(
                ast.Name(self.ITER, ast.Load()), [gen.iter], []), gen.iter)
        return node

    visit_ListComp = _wrap_comp
    visit_DictComp = _wrap_comp
    visit_GeneratorExp = _wrap_comp


@dataclass
class DeterministicSandbox:
    """Load + run contract code under the whitelist and an instruction budget
    (RuntimeCostAccounter role; budget = charged statements + iterations)."""

    instruction_budget: int = 1_000_000

    def load(self, source: str, bindings: dict | None = None) -> dict:
        """Validate, instrument, and execute a contract module's top level.
        Returns its namespace; classes/functions defined there keep charging
        against this sandbox's budget when called later. ``bindings`` are
        extra names made visible (the framework types the contract needs —
        the whitelisted-classes analog)."""
        tree = validate(source)
        tree = _CostTransformer().visit(tree)
        ast.fix_missing_locations(tree)
        code = compile(tree, "<sandboxed-contract>", "exec")
        self._spent = 0

        def charge(units: int = 1):
            self._spent += units
            if self._spent > self.instruction_budget:
                raise SandboxCostExceeded(
                    f"instruction budget {self.instruction_budget} exhausted")

        def charged_iter(it):
            for item in iter(it):
                charge()
                yield item

        def _size_units(v) -> int:
            """Price an operand: ints by bit length, sized containers by
            length, everything else flat."""
            if isinstance(v, bool):
                return 1
            if isinstance(v, int):
                return max(1, v.bit_length() // 64)
            try:
                return max(1, len(v) // 64)
            except TypeError:
                return 1

        def guarded_binop(op: str, left, right):
            """Evaluate **, *, << or + with the result size pre-charged, so
            a single statement cannot smuggle unbounded work past the
            per-statement accounting (ADVICE r1: `x = 10**10**8`). An "="
            suffix selects the in-place operator, preserving aliased-mutable
            semantics for augmented assignments (`b += [2]`)."""
            import operator as _op
            inplace = op.endswith("=")
            base_op = op[:-1] if inplace else op
            if base_op == "%":
                return guarded_mod(op, left, right)
            if base_op == "**":
                # |base| <= 1 powers are O(1) no matter the exponent
                if isinstance(left, int) and isinstance(right, int) \
                        and not isinstance(left, bool) \
                        and right > 0 and abs(left) > 1:
                    charge(max(1, (abs(left).bit_length() * right) // 64))
                apply = _op.ipow if inplace else _op.pow
            elif base_op == "<<":
                if isinstance(left, int) and isinstance(right, int) \
                        and right > 0 and left != 0:
                    charge(max(1, (abs(left).bit_length() + right) // 64))
                apply = _op.ilshift if inplace else _op.lshift
            elif base_op == "+":
                # sequence concatenation priced by combined length, so
                # `s = s + s` doubling charges exponentially alongside the
                # data and hits the budget long before memory; numeric adds
                # charge their flat statement cost only
                if not isinstance(left, (int, float, complex)):
                    charge(_size_units(left) + _size_units(right))
                apply = _op.iadd if inplace else _op.add
            else:  # '*': sequences replicate, big ints multiply
                if isinstance(right, int) and not isinstance(right, bool):
                    try:
                        n = len(left)
                    except TypeError:
                        n = None
                    if n is not None and right > 0:
                        charge(max(1, (n * right) // 64))
                if isinstance(left, int) and not isinstance(left, bool):
                    try:
                        n = len(right)
                    except TypeError:
                        n = None
                    if n is not None and left > 0:
                        charge(max(1, (n * left) // 64))
                if isinstance(left, int) and isinstance(right, int):
                    charge(max(1,
                               (_size_units(left) + _size_units(right)) // 2))
                apply = _op.imul if inplace else _op.mul
            return apply(left, right)

        def guarded_mod(op: str, left, right):
            """%-formatting prices the widths its spec string demands BEFORE
            evaluating ('%0200000000d' % 1 is a 200 MB allocation for ~2
            charged units otherwise — ADVICE r2). Numeric modulo passes
            through at flat statement cost."""
            import operator as _op
            if isinstance(left, (str, bytes, bytearray)):
                template = (left if isinstance(left, str)
                            else left.decode("latin-1"))
                width = _percent_width(template)
                if width > _MAX_FORMAT_WIDTH:
                    raise SandboxCostExceeded(
                        f"%-format width {width} exceeds "
                        f"{_MAX_FORMAT_WIDTH}")
                charge(max(1, (len(left) + width) // 64))
            return (_op.imod if op.endswith("=") else _op.mod)(left, right)

        def guarded_pow(base, exp, mod=None):
            if mod is not None:
                charge(_size_units(base) + _size_units(exp) +
                       _size_units(mod))
                return pow(base, exp, mod)
            return guarded_binop("**", base, exp)

        def guarded_range(*args):
            r = range(*args)
            # length computed arithmetically: len() overflows past maxsize
            start, stop, step = r.start, r.stop, r.step
            if step > 0:
                n = max(0, (stop - start + step - 1) // step)
            else:
                n = max(0, (start - stop - step - 1) // -step)
            if n > self.instruction_budget:
                raise SandboxCostExceeded(
                    f"range of {n} exceeds instruction budget "
                    f"{self.instruction_budget}")
            # charge proportionally up front: consumers that bypass
            # charged_iter (list(range(n)), sum(range(n))) must not get
            # budget-squared free work out of repeated in-budget ranges
            charge(max(1, n // 64))
            return r

        def guarded_format(value, spec=""):
            """format() with the spec's width priced before evaluation
            (format(1, '>200000000') is a one-call 200 MB allocation
            otherwise — ADVICE r2)."""
            if isinstance(spec, str) and spec:
                width = _spec_width(spec)
                if width > _MAX_FORMAT_WIDTH:
                    raise SandboxCostExceeded(
                        f"format width {width} exceeds {_MAX_FORMAT_WIDTH}")
                charge(max(1, width // 64))
            return format(value, spec)

        def guarded_bytes(*args):
            if args and isinstance(args[0], int) \
                    and not isinstance(args[0], bool):
                charge(max(1, args[0] // 64))
            return bytes(*args)

        def _builtin(name):
            return (__builtins__[name] if isinstance(__builtins__, dict)
                    else getattr(__builtins__, name))

        safe_builtins = {name: _builtin(name) for name in _SAFE_BUILTIN_NAMES}
        # class-statement machinery (builds only already-validated code)
        safe_builtins["__build_class__"] = _builtin("__build_class__")
        # cost-capped replacements for the unbounded-in-one-call builtins
        safe_builtins["pow"] = guarded_pow
        safe_builtins["range"] = guarded_range
        safe_builtins["bytes"] = guarded_bytes
        safe_builtins["format"] = guarded_format
        namespace = {
            "__builtins__": safe_builtins,
            "__name__": "sandboxed_contract",
            _CostTransformer.CHARGE: charge,
            _CostTransformer.ITER: charged_iter,
            _CostTransformer.BINOP: guarded_binop,
        }
        namespace.update(bindings or {})
        try:
            exec(code, namespace)
        except SandboxCostExceeded as e:
            raise SandboxBudgetError(str(e)) from None
        return namespace

    @property
    def spent(self) -> int:
        return getattr(self, "_spent", 0)

    def run(self, fn, *args, **kwargs):
        """Call a function loaded by this sandbox (charging continues).

        This is the HOST boundary: a budget kill (BaseException inside the
        sandbox, uncatchable there) surfaces as :class:`SandboxBudgetError`
        (a plain Exception) so verifier/flow error paths handle it like any
        contract failure. Always call sandboxed functions through here."""
        try:
            return fn(*args, **kwargs)
        except SandboxCostExceeded as e:
            raise SandboxBudgetError(str(e)) from None
