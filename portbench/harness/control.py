"""The control: the reference with one of the configuration's guarantees
broken, put in the program's place, and judged as a run judges the program.

Each entry names its control (``CONTROL`` in ``entries/<entry>.py``), the
step a later change might be tempted to take: Ed25519 signatures with
s >= L accepted (no range check) for the signature groups, and the cash
conservation rule skipped for the payments. Its reading is the number of
wrong verdicts it gives over the cell's distinct inputs (a run's window
cycles through the same inputs, so it compares each of them at least
once).
"""
from __future__ import annotations

import entries

from .runner import input_pool, load, make_inputs, reference_pool


def control_reading(cell_name: str, seed: int, overrides=None,
                    root=None) -> dict:
    """{"control": name, "wrong_verdicts": n, "distinct": n} of the control
    on the cell's inputs for ``seed``."""
    kw = {} if root is None else {"root": root}
    cell = load("cells", cell_name, **kw)
    config = load("configs", cell["config"], **kw)
    mix = dict(load("traffic", cell["traffic"], **kw))
    mix.update(overrides or {})
    entry = entries.load(mix["entry"])
    with input_pool() as pool:
        prepared = entry.prepare(make_inputs(pool, seed, mix, config)(),
                                 seed, mix, config)
    with reference_pool() as pool:
        sound = entry.reference(pool, prepared.plain, mix)
        broken = entry.reference(pool, prepared.plain, mix, entry.CONTROL)
    return {"control": entry.CONTROL, "distinct": len(prepared.plain),
            "wrong_verdicts": sum(entry.mismatches(b, a)
                                  for a, b in zip(sound, broken))}


def main(argv=None) -> int:
    import argparse
    import json
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    for seed in args.seeds:
        out = control_reading(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0
