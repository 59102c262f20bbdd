"""SPHINCS-256: stateless hash-based (post-quantum) signatures.

Reference parity: the SPHINCS256_SHA512_256 scheme (reference Crypto.kt:139-156,
registered via BouncyCastle's SPHINCS-256 signer with a SHA-512/256 tree
digest). Same construction and parameters as the SPHINCS-256 paper (Bernstein
et al., EUROCRYPT 2015): WOTS+ (w = 16) one-time signatures, HORST (t = 2^16,
k = 32) few-time signatures at the bottom, and a 60-level hypertree split into
d = 12 layers of height 5. Two deliberate deviations, documented because they
change the byte format (not the construction):

- Tweakable hashing a la SPHINCS+: F/H/PRF are SHA-512/256 over an explicit
  (tag, address) prefix instead of the paper's ChaCha12 permutation with XOR
  bitmasks. Same 256-bit interfaces; the digest is the one the scheme name
  commits to; domain separation comes from the address, which every hash call
  binds to its position in the hypertree.
- WOTS+ public keys compress with one wide hash instead of an L-tree, and
  HORST reveals full-height auth paths (no level-6 truncation): simpler
  verification, slightly larger signatures (~45 KB vs 41 KB).

Signatures therefore verify only within this framework — consistent with the
canonical codec replacing Kryo everywhere else (SURVEY.md §7 phase 0).

Layout
------
private key: sk_seed(32) ‖ sk_prf(32) ‖ pub_seed(32)
public key:  pub_seed(32) ‖ root(32)
signature:   R(32) ‖ HORST[k × (sk(32) ‖ auth(16×32))] ‖
             d × (WOTS[67×32] ‖ auth(5×32))
"""
from __future__ import annotations

import hashlib

N = 32                  # hash output bytes
W_LOG = 4               # WOTS+ Winternitz log2(w)
W = 1 << W_LOG
WOTS_L1 = 64            # 256 / W_LOG message digits
WOTS_L2 = 3             # checksum digits: max 64*15 = 960 < 16^3
WOTS_LEN = WOTS_L1 + WOTS_L2
HORST_LOGT = 16         # t = 2^16 leaves
HORST_K = 32            # revealed leaves per signature
LAYERS = 12             # hypertree layers
SUB_H = 5               # per-layer subtree height
TREE_H = LAYERS * SUB_H  # 60
HORST_LAYER = LAYERS     # address byte for the HORST instances

SIG_LEN = (N + HORST_K * (N + HORST_LOGT * N)
           + LAYERS * (WOTS_LEN * N + SUB_H * N))


def _addr(layer: int, tree: int, leaf: int = 0, chain: int = 0,
          pos: int = 0) -> bytes:
    return (bytes([layer]) + tree.to_bytes(8, "big") + leaf.to_bytes(4, "big")
            + chain.to_bytes(2, "big") + pos.to_bytes(2, "big"))


def _hash(tag: bytes, addr: bytes, data: bytes) -> bytes:
    return hashlib.new("sha512_256", tag + addr + data).digest()


def _prf(seed: bytes, addr: bytes) -> bytes:
    return _hash(b"\x00" + seed, addr, b"")


def _f(pub_seed: bytes, addr: bytes, x: bytes) -> bytes:
    return _hash(b"\x01" + pub_seed, addr, x)


def _h2(pub_seed: bytes, addr: bytes, left: bytes, right: bytes) -> bytes:
    return _hash(b"\x02" + pub_seed, addr, left + right)


def _thash(pub_seed: bytes, addr: bytes, data: bytes) -> bytes:
    """Wide compression (WOTS+ pk, message digests)."""
    return _hash(b"\x03" + pub_seed, addr, data)


# ---------------------------------------------------------------------------
# WOTS+
# ---------------------------------------------------------------------------

def _wots_digits(msg32: bytes) -> list[int]:
    digits = []
    for byte in msg32:
        digits.append(byte >> 4)
        digits.append(byte & 15)
    checksum = sum(W - 1 - d for d in digits)
    for shift in (8, 4, 0):
        digits.append((checksum >> shift) & 15)
    return digits


def _chain(pub_seed: bytes, addr_lcl: tuple, x: bytes, start: int,
           steps: int) -> bytes:
    layer, tree, leaf, chain = addr_lcl
    for pos in range(start, start + steps):
        x = _f(pub_seed, _addr(layer, tree, leaf, chain, pos), x)
    return x


def _wots_leaf_from_chains(pub_seed, layer, tree, leaf, ends) -> bytes:
    return _thash(pub_seed, _addr(layer, tree, leaf, 0xFFFF), b"".join(ends))


def _wots_sign(sk_seed, pub_seed, layer, tree, leaf, msg32):
    digits = _wots_digits(msg32)
    sig = []
    for i, d in enumerate(digits):
        sk = _prf(sk_seed, _addr(layer, tree, leaf, i))
        sig.append(_chain(pub_seed, (layer, tree, leaf, i), sk, 0, d))
    return b"".join(sig)


def _wots_leaf_from_sig(pub_seed, layer, tree, leaf, sig: bytes,
                        msg32: bytes) -> bytes:
    digits = _wots_digits(msg32)
    ends = [
        _chain(pub_seed, (layer, tree, leaf, i), sig[i * N:(i + 1) * N],
               d, W - 1 - d)
        for i, d in enumerate(digits)
    ]
    return _wots_leaf_from_chains(pub_seed, layer, tree, leaf, ends)


def _wots_keygen_leaf(sk_seed, pub_seed, layer, tree, leaf) -> bytes:
    ends = []
    for i in range(WOTS_LEN):
        sk = _prf(sk_seed, _addr(layer, tree, leaf, i))
        ends.append(_chain(pub_seed, (layer, tree, leaf, i), sk, 0, W - 1))
    return _wots_leaf_from_chains(pub_seed, layer, tree, leaf, ends)


# ---------------------------------------------------------------------------
# Merkle helpers (shared by HORST and the hypertree subtrees)
# ---------------------------------------------------------------------------

def _build_tree(pub_seed, layer, tree, leaves: list[bytes]):
    """Bottom-up levels; returns (levels, root). levels[0] = leaves."""
    levels = [leaves]
    lvl = 0
    while len(levels[-1]) > 1:
        cur = levels[-1]
        lvl += 1
        nxt = [
            _h2(pub_seed, _addr(layer, tree, i, 0x8000 + lvl), cur[2 * i],
                cur[2 * i + 1])
            for i in range(len(cur) // 2)
        ]
        levels.append(nxt)
    return levels, levels[-1][0]


def _auth_path(levels, leaf_idx: int) -> list[bytes]:
    path = []
    idx = leaf_idx
    for lvl in levels[:-1]:
        path.append(lvl[idx ^ 1])
        idx >>= 1
    return path


def _root_from_auth(pub_seed, layer, tree, leaf_idx: int, node: bytes,
                    path: list[bytes]) -> bytes:
    idx = leaf_idx
    for lvl, sib in enumerate(path, start=1):
        pair = (sib, node) if idx & 1 else (node, sib)
        node = _h2(pub_seed, _addr(layer, tree, idx >> 1, 0x8000 + lvl), *pair)
        idx >>= 1
    return node


# ---------------------------------------------------------------------------
# HORST
# ---------------------------------------------------------------------------

def _horst_sign(horst_seed, pub_seed, tree, selection: list[int]):
    sks = [_prf(horst_seed, _addr(HORST_LAYER, tree, j))
           for j in range(1 << HORST_LOGT)]
    leaves = [_f(pub_seed, _addr(HORST_LAYER, tree, j), sk)
              for j, sk in enumerate(sks)]
    levels, root = _build_tree(pub_seed, HORST_LAYER, tree, leaves)
    sig = b"".join(
        sks[j] + b"".join(_auth_path(levels, j)) for j in selection)
    return sig, root


def _horst_root_from_sig(pub_seed, tree, selection, sig: bytes):
    """Recompute the HORST root from the k revealed (sk, auth) pairs; returns
    None when the revealed paths disagree (forged/corrupt signature)."""
    per = N + HORST_LOGT * N
    root = None
    for i, j in enumerate(selection):
        blob = sig[i * per:(i + 1) * per]
        sk, path_b = blob[:N], blob[N:]
        leaf = _f(pub_seed, _addr(HORST_LAYER, tree, j), sk)
        path = [path_b[l * N:(l + 1) * N] for l in range(HORST_LOGT)]
        r = _root_from_auth(pub_seed, HORST_LAYER, tree, j, leaf, path)
        if root is None:
            root = r
        elif r != root:
            return None
    return root


# ---------------------------------------------------------------------------
# Hypertree + public API
# ---------------------------------------------------------------------------

def _subtree(sk_seed, pub_seed, layer, tree):
    leaves = [_wots_keygen_leaf(sk_seed, pub_seed, layer, tree, leaf)
              for leaf in range(1 << SUB_H)]
    return _build_tree(pub_seed, layer, tree, leaves)


def _message_indices(r: bytes, pub_root: bytes, message: bytes):
    """(R, root, M) → (60-bit hypertree leaf index, k HORST selections)."""
    digest = _hash(b"\x04" + r, b"", pub_root + message)
    stream = b"".join(
        _hash(b"\x05", ctr.to_bytes(4, "big"), digest) for ctr in range(3))
    idx = int.from_bytes(stream[:8], "big") >> (64 - TREE_H)
    selection = [
        int.from_bytes(stream[8 + 2 * i:10 + 2 * i], "big")
        for i in range(HORST_K)
    ]
    return idx, selection


def keygen(entropy: bytes):
    """entropy(32) → (public(64), private(96)). Deterministic."""
    if len(entropy) != 32:
        raise ValueError("SPHINCS-256 keygen needs 32 bytes of entropy")
    sk_seed = _hash(b"\x06", b"sk", entropy)
    sk_prf = _hash(b"\x06", b"pr", entropy)
    pub_seed = _hash(b"\x06", b"pu", entropy)
    _, root = _subtree(sk_seed, pub_seed, LAYERS - 1, 0)
    return pub_seed + root, sk_seed + sk_prf + pub_seed


def sign(private: bytes, message: bytes) -> bytes:
    sk_seed, sk_prf, pub_seed = private[:32], private[32:64], private[64:96]
    _, pub_root = _subtree(sk_seed, pub_seed, LAYERS - 1, 0)
    r = _hash(b"\x07" + sk_prf, b"", message)
    idx, selection = _message_indices(r, pub_root, message)

    horst_seed = _prf(sk_seed, _addr(HORST_LAYER, idx, 0xFFFFFFFF))
    horst_sig, root = _horst_sign(horst_seed, pub_seed, idx, selection)

    parts = [r, horst_sig]
    node_idx = idx
    for layer in range(LAYERS):
        leaf = node_idx & ((1 << SUB_H) - 1)
        tree = node_idx >> SUB_H
        parts.append(_wots_sign(sk_seed, pub_seed, layer, tree, leaf, root))
        levels, root = _subtree(sk_seed, pub_seed, layer, tree)
        parts.append(b"".join(_auth_path(levels, leaf)))
        node_idx = tree
    return b"".join(parts)


def verify(public: bytes, message: bytes, signature: bytes) -> bool:
    if len(public) != 2 * N or len(signature) != SIG_LEN:
        return False
    pub_seed, pub_root = public[:N], public[N:]
    r = signature[:N]
    idx, selection = _message_indices(r, pub_root, message)

    off = N
    horst_len = HORST_K * (N + HORST_LOGT * N)
    root = _horst_root_from_sig(pub_seed, idx,
                                selection, signature[off:off + horst_len])
    if root is None:
        return False
    off += horst_len

    node_idx = idx
    for layer in range(LAYERS):
        leaf = node_idx & ((1 << SUB_H) - 1)
        tree = node_idx >> SUB_H
        wots_sig = signature[off:off + WOTS_LEN * N]
        off += WOTS_LEN * N
        node = _wots_leaf_from_sig(pub_seed, layer, tree, leaf, wots_sig, root)
        path = [signature[off + l * N:off + (l + 1) * N] for l in range(SUB_H)]
        off += SUB_H * N
        root = _root_from_auth(pub_seed, layer, tree, leaf, node, path)
        node_idx = tree
    return root == pub_root
