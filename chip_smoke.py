#!/usr/bin/env python3
"""Smoke run of corda_tpu_torch on one NVIDIA GPU: builds every kernel of the
port from the sources in this checkout, holds each against its plain PyTorch
version, and drives the signature-verification service paths end to end —
Ed25519 and ECDSA (secp256k1, secp256r1) —, every ECDSA verify mode of
``verify_batch``, the Merkle hashing path (bulk tear-off proof checks and
bulk transaction ids), the sharded path over meshes of one card, the
SIMM margin and the out-of-process verifier (workers on the card behind an
in-memory bus).

    python3 chip_smoke.py [--seed N] [--only-kernels NAMES] [--ab PARENT]

Phases (any failure exits non-zero; nothing is caught):

1. probe   — card name and power limit (nvidia-smi), torch/CUDA versions,
             parallel build of the ten CUDA kernel libraries and
             libscalarmath (seconds, and nvcc's register/spill report); the
             native scalar prep must be in use.
2. kernels — each kernel against its plain PyTorch version on the card at
             buckets 256, 1024 (the interactive batch), 4096 and 32768:
             B2 Ed25519 split-k, B3 secp256k1 hybrid GLV and B4 secp256r1
             half-gcd split, on adversarial batches from the smoke's own
             signing (B3's with crafted r + n < p signatures, B4's with
             half-gcd fallbacks), and on the same batches B5 windowed
             (secp256k1, secp256r1), B8 Shamir (secp256k1, secp256r1) and
             B8 GLV (secp256k1), and B7 Ed25519 Shamir and windowed on one
             adversarial batch of 4,096 items signed once (s >= L, R y >=
             p, undecodable keys and R among them), prepped once and tiled.
             Verdicts bit-identical and equal to the
             construction; CUDA-event medians of both versions, the
             card's least time for the same work, and each launch's lanes
             a signature and warps a multiprocessor (B2 and both B7
             kernels run lane pairs up to 16384 items, one lane above, and
             both B7 kernels are timed at 16384 too; B3, B4, B5 and both
             B8 kernels run lane pairs at every size). B5 and B8 GLV are
             also held raw against their plain versions at the ragged
             sizes 1, 31, 33, 4095 and 4097, and both B7 libraries with
             each lane variant forced at those sizes, their lane
             threshold +-1 and every bucket (both variants timed in turns
             at the threshold). The plain versions are timed at the
             buckets the kernels line reads. A freshly loaded signature
             library has also been held against its plain version on
             known answers (ops/known_answers.py).
             Then B10 (SIMM margin)
             on the demo book and seeded books of 1024, 2^16 and 2^20
             trades: equal to its plain version bit for bit (and so within
             1e-5 of it, and 2 cents up to 1024 trades), within 1e-5 of the
             float64 margin, and equal to itself on a second launch; its
             time on the card from a torch.profiler trace taken in a fresh
             process (retried in another fresh process when the trace holds
             no kernel; failing after three), beside torch.sum(sens, 0).
             Then B6
             (SHA-256/Merkle):
             hash_pairs at 2^10, 2^14, 2^17 and 2^20 pairs, merkle_root on
             65,536 trees of 8 and of 16 leaves and one tree of 2^20
             leaves, sha256_blocks on 65,536 messages of 1 and of 4 blocks:
             bit-identical to the plain versions, a random 256 lanes equal
             to hashlib.
3. modes   — weierstrass.verify_batch for every (curve, mode) on 32768
             items (1/16 tampered): secp256k1 hybrid, windowed, plain and
             glv, secp256r1 halfgcd, windowed and plain (plain, windowed
             and glv once more on 1024 items, for the 1024 rows of B8 and
             B5). One warm-up pass,
             two timed passes in turns (secp256r1: halfgcd, windowed,
             windowed, halfgcd); verdicts equal to the construction and
             exactly the mode's kernel launched in every run (counts set to
             0 just before, read just after); verifies/s, prep seconds and
             kernel ms per pair, secp256r1 windowed against halfgcd side by
             side, each of those two once more under torch.profiler for the
             card's idle share.
4. merkle  — the Merkle path at the default DEVICE_CROSSOVER (2^17):
             verify_filtered_batch over 131,072 oracle-shaped tear-offs
             (4,096 distinct seeded transactions tiled x32, 1/16 tampered)
             and batch_roots over 131,072 component-hash lists (oracle- and
             cash-shaped), each once on the host route and once on the
             card in turns (host, card, card, host); verdicts and roots
             must equal each other, the construction and
             WireTransaction.id, and B6 must have launched (hash_pairs /
             merkle_root counts set to 0 just before the first card call
             and read just after). Each device window is repeated under
             torch.profiler for the card's idle share; one round is timed
             on both routes at 2^8..2^17 pairs for the H100's own
             host/device crossover.
5. mesh    — corda_tpu_torch.parallel on meshes of 1 and 2 shards of the
             card (two shards: two streams): sharded_verify_batch_ed25519
             and the secp256k1/secp256r1 word-form wrappers on 32768 items
             (equal to the construction and the unsharded verify_batch),
             the sharded B7 Shamir and windowed callables on a prepared
             32768 batch (one lane for the 32768-item shard, lane pairs for
             the two 16384-item ones, counted by lanes),
             sharded_merkle_root on 2^20 leaves (equal to
             hashlib and merkle_root), tx_verify_step on 32768 signatures
             and 2^17 leaves, and SignatureBatcher(mesh=...) bulk groups
             (the 2-shard one with a secp256k1 and a secp256r1 group too);
             each path's launch counts set to 0 just before it and read
             just after; verifies/s per mesh size and the card's idle share
             of a traced 2-shard batcher window.
6. simm    — compute_margin_cents on the demo book and a 2^20-trade book on
             the card (B10 launched once each), against the float64 margin.
7. service — SignatureBatcher(device="cuda") driven through submit_group:
             Ed25519 (bulk groups of 32768, 1024-item interactive groups,
             single submits), then secp256k1 and secp256r1 (bulk groups of
             32768 and interactive 1024 groups each), then a mixed
             Ed25519/secp256k1/secp256r1 verify_signed run through the
             verifier service on real SignedTransactions (DummyContract
             states, a dict-backed services). Verdicts must match the
             construction and a random 256 per scheme the host oracle; no
             batch may fail over to the host, every breaker stays closed,
             and each path's kernels must have launched (counts set to 0
             just before each path and read just after; the kernels line
             gives each kernel's count on its own scheme's path — B5/B8 on
             the modes phase, B7 on the mesh phase, B10 on the simm
             phase —, the mixed run's are printed with the ECDSA
             results). Each path's bulk groups then run once more
             under torch.profiler (CORDA_TPU_PROFILE_DIR), whose trace gives
             the card's busy share of that window (a window whose three
             profiler sessions hold no kernel record is reported as not
             measured: on the card's machine the profiler at times stops
             recording device activity for the rest of a process).
7b. oop    — make_verifier_service("OutOfProcess") over an in-memory bus,
             its workers' SignatureBatcher(device="cuda",
             host_crossover=0) on the card: the service phase's 512 mixed
             transactions through verify_signed (outcomes equal to the
             construction, B2, B3 and B4 launched, no host routing, every
             breaker closed) beside the service phase's mixed tx/s; an
             untampered Ed25519 group of 32768 (resolves None) and the
             service phase's tampered one (fails with the first bad key's
             message) through verify_signatures, beside the direct
             batcher's verifies/s; and 64 mixed transactions dealt to two
             workers, one stopped unannounced and detached before the bus
             is pumped: every future resolves exactly once with the
             construction's outcome and the dead worker verified none.
8. ab      — only with --ab PARENT (a directory holding an earlier commit's
             corda_tpu_torch/csrc, e.g. unpacked by git archive): that
             commit's B3, B5, both B7 and both B8 kernels built beside this
             checkout's, each side's launcher bound by its own signature
             in its source, and timed on the same inputs in turns at 256
             to 32768 items (B5 and B8 Shamir for each curve; a side whose
             launcher takes the lanes runs each lane variant as a side of
             its own) after a raw bit-identity check, with each side's
             warps a multiprocessor and the parents' ptxas report; and the
             interactive 1k latency of the secp256k1 service path with the
             parent's B3 behind the wrapper and with this checkout's, in
             turns (parent, change, change, parent).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. ``--only-kernels`` runs phases 1 and 2 only,
for the named kernels (and phase 8 with --ab, for those kernels), and
prints neither. Without CUDA, or outside a checkout of the
repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import glob
import json
import multiprocessing
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

#: Peak rates of one H100 SXM (NVIDIA data-sheet dense figures at the
#: 700 W limit): 3.35 TB/s of HBM; 67 TFLOP/s float32 outside
#: the tensor cores, i.e. 128 FMA lanes a clock per SM. Integer multiply-add
#: (IMAD) issues at half the float32 lane rate (64 a clock per SM on compute
#: capability 9.0), so 67e12 / 2 / 2 = 16.75e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4


def imad_per_sig(products: int, squarings: int, fold: int) -> int:
    """Field products of 64 + ``fold`` 32x32->64 multiplies and squarings
    of 36 + ``fold`` (the triangular square the function needs, whatever a
    kernel does), each multiply counted as 2 IMAD issue slots. ``fold`` is
    the reduction's own multiplies: 8 where the high half is multiplied
    back in (x 38 for p25519, x 977 for secp256k1), 0 for P-256, whose
    FIPS 186-4 fast reduction only adds and subtracts words."""
    return 2 * (products * (64 + fold) + squarings * (36 + fold))


#: Per signature, counted in each kernel's source note:
#: B2 (csrc/ed25519_split.cu): 1303 products, 766 squarings; wire arrays
#: bb_idx 64, a_packed 64, rows 192, r_packed 32 and the verdict, plus the
#: six Niels tables once. The bound counts the least work known for the
#: function: the reference's ladder, or the B7 kernels' 4-bit windows over
#: a cached -A table, which need less than the reference's ladders, each
#: computing T = E H only where an addition reads it (Hisil-Wong-Carter-
#: Dawson 2008 s. 4.3; ref10's p1p1-to-p2 conversion): not in a doubling
#: or an addition that a doubling or the final acceptance follows.
#: ``design_imad``: what a kernel's design issues where it differs from the
#: bound's count, by lanes a signature (B2, B3, B4, B5, both B7 kernels and
#: B8 r1 on lane pairs run some products on both lanes: 1406 products and
#: 1020 squarings for B2, 1850 and 256 for B3, 2330 and 262 for B4, 2588
#: and 518 for B5 k1, 4314 and 518 for B5 r1, 2176 and 1008 for B7 Shamir,
#: 1816 and 1516 for B7 windowed, 6672 and 512 for B8 r1; the one-lane
#: kernels of B2 and both B7 kernels square with a full product: 2069,
#: 3105 and 3034 products; B8 GLV's and B8 k1's pairs run exactly the
#: bound's products).
#: B3 (csrc/secp256k1_hybrid.cu): 1823 products, 256 squarings; wire g_idx
#: 64, q_bits 64, pts 128, r_limbs 32 and the verdict, plus each distinct
#: G-table row gathered (x 32 + y 32 + flag 1 bytes).
#: B4 (csrc/secp256r1_split.cu): 2044 products, 393 squarings; wire g_idx
#: 64, q_digits 32, q_x/q_y 64, xd 32 and the verdict, plus each distinct
#: row gathered from the G and G' tables.
#: B7 Shamir (csrc/ed25519_shamir.cu): 1844 products, 1008 squarings (4-bit
#: Straus windows, T skipped in 189 doublings and 64 cached additions; the
#: kernels compute every T, 2097 products; the reference's bit ladder needs
#: 3339 and 1024); wire s/k bit planes 512, -A 128, R 64 and the verdict.
#: B7 windowed (csrc/ed25519_windowed.cu): 1519 products, 1262 squarings
#: (4-bit windows of k over a cached -A table, T skipped in 189 doublings
#: and 64 additions; the kernels compute every T, 1772 products; the
#: reference's 2-bit digits need 2297 and 1274); wire b_idx 64, a_digits
#: 128, -A 128, r_y 32, r_sign 1 and the verdict, plus each distinct Niels
#: row gathered (96 bytes).
#: B8 Shamir (csrc/weierstrass_shamir.cu): secp256k1 4622 products, 512
#: squarings; secp256r1 6160 and 768; wire u1/u2 bit planes 512, q_pts 96,
#: r_cands 64 and the verdict. B8 GLV (csrc/secp256k1_glv.cu): 2438
#: products, 256 squarings; wire bits4 512, pts4 384, r_cands 64 and the
#: verdict. B5 windowed (csrc/weierstrass_windowed.cu): secp256k1 2565 and
#: 518, secp256r1 3773 and 777; wire g_idx 64, q_digits 64, q_x/q_y 64,
#: r_limbs 32, rn_ok 1 and the verdict, plus each distinct G-table row.
KERNELS = {
    "ed25519_split_verify": {
        "imad": imad_per_sig(1303, 766, 8), "wire": 64 + 64 + 192 + 32 + 1,
        "design_imad": {1: imad_per_sig(2069, 0, 8),
                        2: imad_per_sig(1406, 1020, 8)},
        "source": "corda_tpu_torch/csrc/ed25519_split.cu",
        "replaces": "corda_tpu/ops/ed25519.py:346", "lib": "ed25519_split"},
    "secp256k1_hybrid_verify": {
        "imad": imad_per_sig(1823, 256, 8), "wire": 64 + 64 + 128 + 32 + 1,
        "design_imad": {2: imad_per_sig(1850, 256, 8)},
        "source": "corda_tpu_torch/csrc/secp256k1_hybrid.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:1276",
        "lib": "secp256k1_hybrid"},
    "secp256r1_split_verify": {
        "imad": imad_per_sig(2044, 393, 0), "wire": 64 + 32 + 64 + 32 + 1,
        "design_imad": {2: imad_per_sig(2330, 262, 0)},
        "source": "corda_tpu_torch/csrc/secp256r1_split.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:1063",
        "lib": "secp256r1_split"},
    "secp256k1_windowed_verify": {
        "imad": imad_per_sig(2565, 518, 8), "wire": 64 + 64 + 64 + 32 + 2,
        "design_imad": {2: imad_per_sig(2588, 518, 8)},
        "source": "corda_tpu_torch/csrc/weierstrass_windowed.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:889",
        "lib": "weierstrass_windowed", "curve": "secp256k1",
        "mode": "windowed"},
    "secp256r1_windowed_verify": {
        "imad": imad_per_sig(3773, 777, 0), "wire": 64 + 64 + 64 + 32 + 2,
        "design_imad": {2: imad_per_sig(4314, 518, 0)},
        "source": "corda_tpu_torch/csrc/weierstrass_windowed.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:889",
        "lib": "weierstrass_windowed", "curve": "secp256r1",
        "mode": "windowed"},
    "secp256k1_shamir_verify": {
        "imad": imad_per_sig(4622, 512, 8), "wire": 512 + 96 + 64 + 1,
        "source": "corda_tpu_torch/csrc/weierstrass_shamir.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:1435",
        "lib": "weierstrass_shamir", "curve": "secp256k1", "mode": "plain"},
    "secp256r1_shamir_verify": {
        "imad": imad_per_sig(6160, 768, 0), "wire": 512 + 96 + 64 + 1,
        "design_imad": {2: imad_per_sig(6672, 512, 0)},
        "source": "corda_tpu_torch/csrc/weierstrass_shamir.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:1435",
        "lib": "weierstrass_shamir", "curve": "secp256r1", "mode": "plain"},
    "secp256k1_glv_verify": {
        "imad": imad_per_sig(2438, 256, 8), "wire": 512 + 384 + 64 + 1,
        "source": "corda_tpu_torch/csrc/secp256k1_glv.cu",
        "replaces": "corda_tpu/ops/weierstrass.py:508",
        "lib": "secp256k1_glv", "curve": "secp256k1", "mode": "glv"},
    "ed25519_shamir_verify": {
        "imad": imad_per_sig(1844, 1008, 8), "wire": 512 + 128 + 64 + 1,
        "design_imad": {1: imad_per_sig(3105, 0, 8),
                        2: imad_per_sig(2176, 1008, 8)},
        "source": "corda_tpu_torch/csrc/ed25519_shamir.cu",
        "replaces": "corda_tpu/ops/ed25519.py:383", "lib": "ed25519_shamir",
        "ladder": "shamir"},
    "ed25519_windowed_verify": {
        "imad": imad_per_sig(1519, 1262, 8),
        "wire": 64 + 128 + 128 + 32 + 1 + 1,
        "design_imad": {1: imad_per_sig(3034, 0, 8),
                        2: imad_per_sig(1816, 1516, 8)},
        "source": "corda_tpu_torch/csrc/ed25519_windowed.cu",
        "replaces": "corda_tpu/ops/ed25519.py:238",
        "lib": "ed25519_windowed", "ladder": "windowed"},
}
#: Rows of the kernels line beside KERNELS' (read at 32768): lane-pair
#: kernels read at the interactive 1024 bucket — B2's pairs (the
#: ``ed25519_split_verify`` row is its one-lane kernel), with launches by
#: lanes a signature, and B3, B5 and both B8 kernels (pairs at every
#: size), with the launches of their paths' 1024-item batches —, and the
#: B7 kernels' pairs at 16384 (their 32768 rows are their one-lane
#: kernels), the shard of the 2-shard mesh, with launches by lanes a
#: signature.
PAIR_ROWS = {"ed25519_split_verify_pairs": ("ed25519_split_verify", 1024),
             "ed25519_shamir_verify_pairs": ("ed25519_shamir_verify", 16384),
             "ed25519_windowed_verify_pairs": ("ed25519_windowed_verify",
                                               16384),
             **{f"{name}_1024": (name, 1024)
                for name in ("secp256k1_hybrid_verify",
                             "secp256k1_shamir_verify",
                             "secp256r1_shamir_verify",
                             "secp256k1_windowed_verify",
                             "secp256r1_windowed_verify",
                             "secp256k1_glv_verify")}}
#: Sizes at which phase 2 also holds B5 and B8 GLV raw against their plain
#: versions (no timing): ragged edges of a block of lane pairs; the B7
#: kernels are held there too, each lane variant forced, and at their lane
#: threshold (kPairItems) +-1.
RAGGED = (1, 31, 33, 4095, 4097)
RAGGED_KERNELS = ("secp256k1_windowed_verify", "secp256r1_windowed_verify",
                  "secp256k1_glv_verify")
B7_THRESHOLD = (16383, 16385)
#: The verify_batch modes that the modes phase also runs on MODE_SMALL
#: items, for their kernels' 1024 rows.
SMALL_MODES = ("plain", "windowed", "glv")
MODE_SMALL = 1024
#: --ab: the libraries an earlier commit's kernels are built from (their
#: launchers' wire pointers; each side's launcher may also take an int,
#: read from its source by ``c_int_params``), the buckets of the kernel
#: A/B, and the order of its turns.
AB_LIBS = {"secp256k1_hybrid": 7, "weierstrass_shamir": 4,
           "ed25519_shamir": 8, "weierstrass_windowed": 9,
           "ed25519_windowed": 11, "secp256k1_glv": 3}
AB_BUCKETS = (256, 1024, 4096, 16384, 32768)
AB_TURNS = ("parent", "change", "change", "parent")
#: The B7 kernels: an adversarial batch of B7_DISTINCT signed items (1/16
#: tampered with ``tamper``'s seven kinds, plus undecodable R at three fixed
#: places) is prepped once per ladder and tiled to each bucket.
B7_KERNELS = tuple(n for n, k in KERNELS.items() if "ladder" in k)
B7_DISTINCT = 4096
NIELS_ROW_BYTES = 3 * 32
#: The kernels of verify_batch's other modes (B5, B8), by (curve, mode).
MODE_KERNELS = {(k["curve"], k["mode"]): name
                for name, k in KERNELS.items() if "mode" in k}
#: verify_batch's (curve, mode) pairs on the modes phase, the secp256r1
#: windowed and half-gcd routes side by side.
MODE_PAIRS = (("secp256k1", "hybrid"), ("secp256k1", "windowed"),
              ("secp256k1", "plain"), ("secp256k1", "glv"),
              ("secp256r1", "halfgcd"), ("secp256r1", "windowed"),
              ("secp256r1", "plain"))
MODE_BATCH = 32768
#: The curve ids of the launchers that take one.
CURVE_IDS = {"secp256k1": 0, "secp256r1": 1}
NIELS_TABLE_BYTES = 6 * 65536 * 32
G_ROW_BYTES = 32 + 32 + 1

BUCKETS = (256, 1024, 4096, 32768)
#: Phase 2 buckets beyond BUCKETS, by kernel: those of PAIR_ROWS.
ROW_BUCKETS = {lib: bucket for lib, bucket in PAIR_ROWS.values()
               if bucket not in BUCKETS}
#: Service-phase shape. Ed25519: 512 signers over 2048 distinct signed
#: messages, 8 bulk groups of 32768, 25 interactive 1k groups, 20 single
#: submits. ECDSA, per curve: 64 signers over 256 distinct messages (host
#: signing is pure Python, ~0.1 s a signature, spread over a process pool),
#: 4 bulk groups of 32768 and 10 interactive 1k groups; then 512 mixed
#: three-signature transactions through verify_signed. 5 timed kernel runs
#: per bucket (2 of the plain versions at 32768, 1 below: a plain call is
#: launch-bound, 1-4 s at every bucket).
SIGNERS, MESSAGES = 512, 2048
BULK_GROUPS, INTERACTIVE_RUNS, SINGLES, RUNS = 8, 25, 20, 5
EC_SIGNERS, EC_MESSAGES = 64, 256
EC_BULK_GROUPS, EC_INTERACTIVE_RUNS, MIXED_TXS = 4, 10, 512
ORACLE_SAMPLE = 256
#: Out-of-process phase: the service phase's 512 mixed transactions through
#: one worker, two Ed25519 groups of 32768 (one untampered, one the service
#: phase's tampered bulk group), and the first 64 mixed transactions dealt
#: to two workers, one of which dies before the bus is pumped; every wait
#: on the bus under OOP_DEADLINE_S.
OOP_BULK, OOP_DEATH_TXS, OOP_DEADLINE_S = 32768, 64, 600.0

#: B6 (csrc/sha256.cu): 32-bit integer instructions (LOP3, SHF, IADD3) of a
#: Merkle pair — a compression and the pad block's — and of one block of
#: sha256_blocks, counted in the kernel's source note. They issue at the
#: same 64 lanes a clock per SM as IMAD (CUDA C++ Programming Guide,
#: arithmetic instruction throughput for compute capability 9.0).
SHA_PAIR_OPS, SHA_BLOCK_OPS = 2288, 1384
INT32_OPS_PER_S = IMAD_PER_S
PAIR_SIZES = (1 << 10, 1 << 14, 1 << 17, 1 << 20)
ROOT_SHAPES = ((65536, 8), (65536, 16), (1, 1 << 20))    # (trees, leaves)
BLOCK_SHAPES = ((65536, 1), (65536, 4))                  # (messages, blocks)
#: Merkle path: 4,096 distinct seeded transactions per shape; the oracle
#: tear-offs tiled x32 (131,072 proofs), the id lists tiled x16 per shape
#: (131,072 lists); one round timed on both routes at 2^8..2^17 pairs.
MERKLE_DISTINCT, PROOF_TILE, ROOT_TILE = 4096, 32, 16
CROSSOVER_SIZES = tuple(1 << k for k in range(8, 18))
B6_TIMED_CALLS = 20
B6_KERNELS = {
    "sha256_hash_pairs": {"replaces": "corda_tpu/ops/sha256.py:111",
                          "row": ("hash_pairs", 1 << 17)},
    "sha256_merkle_root": {"replaces": "corda_tpu/ops/sha256.py:122",
                           "row": ("merkle_root", (65536, 16))},
}
NOTARY_NAME = "O=Notary Service, L=Zurich, C=CH"

#: B10 (csrc/simm_margin.cu) on the reference's demo book and seeded books
#: (demo_portfolio(n, seed)); its bound is bytes: 48 a trade. 12 float32
#: additions a trade against 67e12 float32 operations a second.
B10 = {"name": "simm_margin", "source": "corda_tpu_torch/csrc/simm_margin.cu",
       "replaces": "corda_tpu/samples/simm_valuation.py:46",
       "lib": "simm_margin"}
SIMM_SIZES = (16, 1024, 1 << 16, 1 << 20)
FP32_PER_S = 67e12
#: Mesh phase: meshes of 1 and 2 shards (2 = two streams on one card);
#: 32768-item batches per scheme, a 2^20-leaf Merkle root, a transaction
#: step of 32768 signatures and 2^17 leaves, and 4 bulk batcher groups.
MESH_SIZES = (1, 2)
MESH_BATCH = 32768
MESH_LEAVES, TX_LEAVES = 1 << 20, 1 << 17
MESH_BULK_GROUPS = 4
#: Profiler sessions a traced window may take: a session now and then
#: records the host's CUDA runtime calls but none of the card's activity
#: (and, once it has, often every later session of the process too). A
#: window with no kernel record is traced again; when every session
#: misses, its idle share is reported as not measured (null) — the path's
#: verdicts and kernel launches are checked apart from the trace. B10's
#: kernel time, a number of the kernels line, is traced in a fresh process
#: each attempt instead, and the run fails when every attempt misses.
TRACE_ATTEMPTS = 3


def idle_share(busy_s, wall_s):
    """The card's idle share of a traced window, or None where the
    profiler recorded no device activity."""
    return None if busy_s is None else 1.0 - busy_s / wall_s


def log(*a):
    print(*a, flush=True)


def log_phase(name: str, t0: float) -> float:
    """Print the seconds of phase ``name`` (started at ``t0``) and return
    the start of the next."""
    now = time.perf_counter()
    log(f"phase {name}: {now - t0:.1f} s")
    return now


def bound_ms(kernel: str, n: int, table_bytes: int) -> tuple[float, str]:
    """The card's least time for ``n`` verifies of ``kernel``: the larger
    of its IMAD count over the IMAD rate and its bytes over the HBM rate."""
    k = KERNELS[kernel]
    ops_s = n * k["imad"] / IMAD_PER_S
    bytes_s = (n * k["wire"] + table_bytes) / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def sha_bound_ms(ops: int, nbytes: int) -> tuple[float, str]:
    """The card's least time for B6 work of ``ops`` 32-bit integer
    instructions that reads and writes ``nbytes``."""
    ops_s = ops / INT32_OPS_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def time_cuda(fn, runs: int) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_s(trace_path: str) -> tuple[float, float]:
    """(seconds the card was busy, seconds of kernel time) in an exported
    torch.profiler Chrome trace: the union of its kernel, copy and memset
    intervals, and the sum of its kernel intervals."""
    events = json.load(open(trace_path))["traceEvents"]
    spans, kernel_us = [], 0.0
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if cat == "kernel":
                kernel_us += float(e["dur"])
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e6, kernel_us / 1e6


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

def _ed_key_job(seed: bytes) -> bytes:
    from corda_tpu_torch.core.crypto import ecmath
    return ecmath.ed25519_public_key(seed)


def _ed_sign_job(job) -> bytes:
    from corda_tpu_torch.core.crypto import ecmath
    seed, pub, msg = job
    return ecmath.ed25519_sign(seed, msg, public=pub)


def make_dataset(pool, seed: int, n_signers: int, n_msgs: int):
    """Signed (pub, sig, msg) items from ``seed`` with the port's own host
    signing, every item valid; keys and signatures made on ``pool``."""
    rng = random.Random(seed)
    seeds = [rng.randbytes(32) for _ in range(n_signers)]
    pubs = list(pool.map(_ed_key_job, seeds))
    msgs = [rng.randbytes(48 + i % 64) for i in range(n_msgs)]
    jobs = [(seeds[i % n_signers], pubs[i % n_signers], m)
            for i, m in enumerate(msgs)]
    sigs = pool.map(_ed_sign_job, jobs, chunksize=64)
    return [(pubs[i % n_signers], sig, msgs[i])
            for i, sig in enumerate(sigs)]


def tamper(item, kind: int, other_pub: bytes):
    """One of seven invalid variants of a valid Ed25519 item."""
    from corda_tpu_torch.core.crypto import ecmath
    pub, sig, msg = item
    if kind == 0:        # flipped signature bit (in s)
        return pub, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:], msg
    if kind == 1:        # flipped message bit
        return pub, sig, msg[:-1] + bytes([msg[-1] ^ 1])
    if kind == 2:        # the wrong key
        return other_pub, sig, msg
    if kind == 3:        # s >= L
        s = int.from_bytes(sig[32:], "little") + ecmath.ED_L
        return pub, sig[:32] + s.to_bytes(32, "little"), msg
    if kind == 4:        # flipped R sign bit
        return pub, sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:], msg
    if kind == 5:        # non-canonical R y (>= p)
        return pub, (2**255 - 10).to_bytes(32, "little") + sig[32:], msg
    return b"\xff" * 32, sig, msg   # undecompressible key


def tile(base, n: int, seed: int, tamper_fn=tamper):
    """``n`` items cycling through ``base``; 1/16 of them tampered (the
    seven kinds in turn). Returns (items, expected verdicts)."""
    rng = random.Random(seed)
    items, want = [], []
    for i in range(n):
        it = base[i % len(base)]
        if i % 16 == 5:
            other = base[(i + 1) % len(base)][0]
            it = tamper_fn(it, (i // 16) % 7, other)
            want.append(False)
        else:
            want.append(True)
        items.append(it)
    order = list(range(n))
    rng.shuffle(order)
    return [items[k] for k in order], [want[k] for k in order]


def _curve(name: str):
    from corda_tpu_torch.core.crypto import ecmath
    return ecmath.SECP256K1 if name == "secp256k1" else ecmath.SECP256R1


def _ecdsa_key_job(job):
    curve_name, priv = job
    curve = _curve(curve_name)
    return curve.mul(priv, curve.g)


def _ecdsa_sign_job(job):
    from corda_tpu_torch.core.crypto import ecmath
    curve_name, priv, msg = job
    return ecmath.ecdsa_sign(_curve(curve_name), priv, msg)


def _ecdsa_oracle_job(job):
    """The host oracle on one (pub, msg, r, s) item (pub may be None)."""
    from corda_tpu_torch.core.crypto import ecmath
    curve_name, (pub, msg, r, s) = job
    return pub is not None and ecmath.ecdsa_verify(_curve(curve_name), pub,
                                                   msg, r, s)


def make_ecdsa_dataset(pool, curve_name: str, seed: int, n_signers: int,
                       n_msgs: int):
    """Valid (pub, msg, r, s) items of ``curve_name`` from ``seed``, keys
    derived and messages signed by the port's host ecmath on a process
    pool. Returns (items, private keys, public points); item i is signed by
    signer i mod ``n_signers``."""
    curve = _curve(curve_name)
    rng = random.Random(seed)
    privs = [rng.randrange(1, curve.n) for _ in range(n_signers)]
    pubs = list(pool.map(_ecdsa_key_job, [(curve_name, d) for d in privs]))
    jobs = [(curve_name, privs[i % n_signers], rng.randbytes(32 + i % 48))
            for i in range(n_msgs)]
    sigs = list(pool.map(_ecdsa_sign_job, jobs, chunksize=8))
    items = [(pubs[i % n_signers], job[2], r, s)
             for i, (job, (r, s)) in enumerate(zip(jobs, sigs))]
    return items, privs, pubs


def tamper_ecdsa(curve, item, kind: int, other_pub):
    """One of seven invalid variants of a valid ECDSA item."""
    pub, msg, r, s = item
    if kind == 0:        # flipped message bit
        return pub, msg[:-1] + bytes([msg[-1] ^ 1]), r, s
    if kind == 1:        # the wrong key
        return other_pub, msg, r, s
    if kind == 2:        # tampered s
        return pub, msg, r, s + 1 if s + 1 <= curve.n // 2 else s - 1
    if kind == 3:        # the high-s twin (rejected by the low-s rule)
        return pub, msg, r, curve.n - s
    if kind == 4:        # r = 0
        return pub, msg, 0, s
    if kind == 5:        # r >= n
        return pub, msg, r + curve.n, s
    return None, msg, r, s   # no decodable key


def crafted_rn(curve, rng, valid: bool):
    """A signature whose R has x(R) = r + n < p, unreachable by honest
    signing: R is chosen first and the key solved for,
    Q = r^-1 (s·R - e·G). B3 accepts it through its r + n candidate; B4
    sends it to the host (a half-gcd fallback)."""
    import hashlib
    from corda_tpu_torch.core.crypto import ecmath
    p, n = curve.p, curve.n
    while True:
        x = n + rng.randrange(1, 1 << 60)
        z = (x * x * x + curve.a * x + curve.b) % p
        y = pow(z, (p + 1) // 4, p)
        if y * y % p == z:
            break
    msg = rng.randbytes(40)
    r = x - n
    e = ecmath._bits2int(hashlib.sha256(msg).digest(), n) % n
    s = rng.randrange(1, n // 2)
    Q = curve.mul(pow(r, n - 2, n), curve.add(curve.mul(s, (x, y)),
                                              curve.mul(n - e, curve.g)))
    return (Q, msg, r, s if valid else (s + 1 if s + 1 <= n // 2 else s - 1))


def to_check(curve, scheme, item):
    """(pub point or None, msg, r, s) → the service's (PublicKey, DER
    signature, content); a missing key becomes an undecodable encoding."""
    from corda_tpu_torch.core.crypto import PublicKey, ecmath
    from corda_tpu_torch.core.crypto.keys import sec1_compress
    pub, msg, r, s = item
    enc = (sec1_compress(curve, pub) if pub is not None
           else b"\x02" + b"\xff" * 32)
    return (PublicKey(scheme, enc), ecmath.ecdsa_sig_to_der(r, s), msg)


def count(snap, name):
    """A meter's count in a metrics snapshot (0 when it never ticked)."""
    return snap.get(name, {}).get("count", 0)


def require_clean(snap, breakers, device_route, label):
    """No batch failed over to the host, every device-route item was
    device-checked and every breaker is closed."""
    if count(snap, "SigBatcher.BatchFailure") != 0:
        raise SystemExit(f"{label}: a device batch failed over to the host")
    if count(snap, "SigBatcher.DeviceChecked") != device_route:
        raise SystemExit(
            f"{label}: DeviceChecked "
            f"{count(snap, 'SigBatcher.DeviceChecked')} != device-route "
            f"items {device_route}")
    if any(b["state"] != "closed" for b in breakers.values()):
        raise SystemExit(f"{label}: a breaker is not closed: {breakers}")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def hold_kernel(name, kernel, plain, args, tables, bucket, final_fn, want):
    """The kernel against its plain version on the same tensors
    (bit-identical raw verdicts), and the verdicts after the host masks
    against the construction. Returns both versions' raw verdicts."""
    import torch
    ok_k = kernel(*args, *tables)
    ok_p = plain(*args, *tables)
    torch.cuda.synchronize()
    k = ok_k.cpu().numpy()
    p = ok_p.cpu().numpy()
    if not (k == p).all():
        raise SystemExit(f"{name} disagrees with its plain version at "
                         f"bucket {bucket}: {(k != p).sum()} verdicts")
    if list(final_fn(k)) != want:
        raise SystemExit(f"{name} verdicts disagree with the construction "
                         f"at bucket {bucket}")
    return k, p


def compare_kernel(name, kernel, plain, args, tables, bucket, table_bytes,
                   final_fn, want, card):
    """One bucket of phase 2: :func:`hold_kernel`, then both versions'
    times."""
    k, p = hold_kernel(name, kernel, plain, args, tables, bucket, final_fn,
                       want)
    ms = time_cuda(lambda: kernel(*args, *tables), RUNS)
    # the plain version is timed at the buckets the kernels line reads
    plain_ms = (time_cuda(lambda: plain(*args, *tables),
                          2 if bucket == 32768 else 1)
                if bucket == 32768 or (name, bucket) in PAIR_ROWS.values()
                else None)
    bms, by = bound_ms(name, bucket, table_bytes)
    err = int(abs(k.astype(int) - p.astype(int)).max())
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "max_abs_err": err, "imad_per_sig": KERNELS[name]["imad"],
           **kernel_geometry(name, bucket)}
    log(json.dumps({"kernel": name, "bucket": bucket, "identical": True,
                    **row, "sig_per_s": bucket / (ms / 1e3), "card": card}))
    return row


def launch_geometry(lib, source: str, target: str, n: int, lanes: int,
                    int_arg) -> dict:
    """Threads a block and warps a multiprocessor of one launch of
    ``target``'s kernel (library ``lib``, C source text ``source``) at
    ``n`` items on ``lanes`` lanes a signature, with the int its
    launcher takes (``int_arg``): the fewer of what one multiprocessor
    holds at once (``<target>_occupancy``, the occupancy calculator, bound
    by its source) and the launched warps spread over every
    multiprocessor."""
    import ctypes
    import torch
    block = getattr(lib, f"{target}_block")()
    occ = getattr(lib, f"{target}_occupancy")
    occ.argtypes = [ctypes.c_int] * len(c_int_params(
        source, f"{target}_occupancy"))
    blocks = occ(block, *([int_arg] if len(occ.argtypes) == 2 else []))
    if blocks < 0:
        raise SystemExit(f"{target}_occupancy failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = blocks * block / 32
    return {"lanes": lanes, "block": block,
            "resident_warps_per_sm": resident,
            "warps_per_sm": min(resident,
                                -(-n * lanes // block) * block / 32 / sms)}


def kernel_geometry(name: str, n: int) -> dict:
    """:func:`launch_geometry` of this checkout's ``name`` at ``n`` items,
    on the lanes its launcher picks, and the design's IMAD a signature on
    them."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import _cuda
    meta = KERNELS[name]
    target = meta["lib"]
    lib = _build.load(target)
    with open(os.path.join(_build.CSRC, f"{target}.cu")) as f:
        source = f.read()
    offered = dict(launch_variants(lib, source, target,
                                   CURVE_IDS.get(meta.get("curve"))))
    lanes = (_cuda.lanes_for(lib, target, n) if len(offered) == 2
             else next(iter(offered)))
    return {**launch_geometry(lib, source, target, n, lanes,
                              offered[lanes]),
            "design_imad_per_sig": meta.get("design_imad", {}).get(
                lanes, meta["imad"])}


def ecdsa_kernel_batch(curve, base, bucket: int, seed: int):
    """An adversarial bucket for phase 2: ``base`` tiled with 1/16
    tampered, plus two crafted r + n < p signatures (one valid), two
    tiny-r signatures and two valid signatures under the keys G and -G at
    fixed places. Returns (items, want)."""
    items, want = tile(base, bucket, seed,
                       lambda it, kind, other: tamper_ecdsa(curve, it, kind,
                                                            other))
    rng = random.Random(seed)
    for pos, valid in ((3, True), (bucket // 2, False)):
        items[pos] = crafted_rn(curve, rng, valid)
        want[pos] = valid
    for pos in (7, bucket - 2):
        pub, msg, _, s = base[pos % len(base)]
        items[pos] = (pub, msg, 1000 + pos, s)
        want[pos] = False
    from corda_tpu_torch.core.crypto import ecmath
    for pos, priv in ((11, 1), (bucket - 5, curve.n - 1)):
        msg = rng.randbytes(36)          # keys G and -G: G + Q = 2G and O
        items[pos] = (curve.mul(priv, curve.g), msg,
                      *ecmath.ecdsa_sign(curve, priv, msg))
        want[pos] = True
    return items, want


def kernel_wrapper(wc, name: str):
    """The wrapper (and launch counter) of an ECDSA kernel of KERNELS."""
    if name == "secp256k1_hybrid_verify":
        return wc.verify_core_hybrid_wide
    if name == "secp256r1_split_verify":
        return wc.verify_core_r1_split
    return {"windowed": wc.verify_core_windowed_single,
            "plain": wc.verify_core,
            "glv": wc.verify_core_glv}[KERNELS[name]["mode"]]


def mode_kernel_case(wc, curve, mode: str, items, dev):
    """Phase 2 inputs of a B5/B8 kernel: (dispatcher, plain version, device
    wire tensors, trailing arguments (tables, curve name), G-table bytes,
    precheck)."""
    import numpy as np
    if mode == "plain":
        *wire, precheck = wc.prepare_batch(curve, items)
        fns, tail, tbytes = (wc.verify_core, wc.verify_core_plain), (
            curve.name,), 0
    elif mode == "glv":
        *wire, precheck = wc.prepare_batch_glv(items)
        fns, tail, tbytes = (wc.verify_core_glv,
                             wc.verify_core_glv_plain), (), 0
    else:
        *wire, precheck = wc.prepare_batch_windowed_single(curve, items)
        fns = (wc.verify_core_windowed_single,
               wc.verify_core_windowed_single_plain)
        tail = (*wc.windowed_tables(curve, dev), curve.name)
        tbytes = np.unique(wire[0] & 0xFFFF).size * G_ROW_BYTES
    return (*fns, wc.wire_to_device(wire, dev), tail, tbytes, precheck)


def modes_phase(wc, dev, ec_base, seed: int, card, per_kernel) -> tuple:
    """Phase 5: verify_batch (the items entry point) for every (curve,
    mode) of MODE_PAIRS on MODE_BATCH items (1/16 tampered) on the card.
    One warm-up pass, then two timed passes in turns (MODE_PAIRS, then
    reversed: the secp256r1 routes run halfgcd, windowed, windowed,
    halfgcd); every run's verdicts must equal the construction and exactly
    the mode's kernel must have launched (counts set to 0 just before the
    run and read just after). The modes of SMALL_MODES run once more on
    MODE_SMALL items (counted under ``<kernel>_<MODE_SMALL>``). The prep
    alone is timed once more, and the two secp256r1 routes run once more
    under torch.profiler for the card's idle share. Returns (results,
    launches by kernel name)."""
    import numpy as np
    data = {}
    for k, name in enumerate(("secp256k1", "secp256r1")):
        curve = _curve(name)

        def tamper_fn(it, kind, other, curve=curve):
            return tamper_ecdsa(curve, it, kind, other)
        data[name] = tile(ec_base[name], MODE_BATCH, seed + k, tamper_fn)
    kernel_of = {("secp256k1", "hybrid"): "secp256k1_hybrid_verify",
                 ("secp256r1", "halfgcd"): "secp256r1_split_verify",
                 **MODE_KERNELS}
    wrappers = {n: kernel_wrapper(wc, n) for n in kernel_of.values()}

    def run(curve_name: str, mode: str, n: int = MODE_BATCH
            ) -> tuple[float, int]:
        items, want = (v[:n] for v in data[curve_name])
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = wc.verify_batch(_curve(curve_name), items, mode=mode,
                              device=dev)
        wall = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in wrappers.items()}
        if list(got) != want:
            raise SystemExit(f"verify_batch {curve_name} {mode}: verdicts "
                             "disagree with the construction")
        mine = kernel_of[(curve_name, mode)]
        others = {n: c for n, c in counts.items()
                  if c and wrappers[n] is not wrappers[mine]}
        if counts[mine] == 0 or others:
            raise SystemExit(f"verify_batch {curve_name} {mode} launched "
                             f"{counts}, expected only {mine}")
        return wall, counts[mine]

    for pair in MODE_PAIRS:
        run(*pair)
    walls = {pair: [] for pair in MODE_PAIRS}
    launches = {}
    for pair in MODE_PAIRS + MODE_PAIRS[::-1]:
        wall, count = run(*pair)
        walls[pair].append(wall)
        name = kernel_of[pair]
        launches[name] = launches.get(name, 0) + count
    # SMALL_MODES once more on MODE_SMALL items
    for pair in MODE_PAIRS:
        if pair[1] in SMALL_MODES:
            launches[f"{kernel_of[pair]}_{MODE_SMALL}"] = run(
                *pair, MODE_SMALL)[1]
    rows = {}
    for curve_name, mode in MODE_PAIRS:
        items, _ = data[curve_name]
        t0 = time.perf_counter()
        wc._prepare(_curve(curve_name), mode, items)
        prep_s = time.perf_counter() - t0
        kernel = kernel_of[(curve_name, mode)]
        wall = statistics.median(walls[(curve_name, mode)])
        kernel_ms = per_kernel[kernel][MODE_BATCH]["ms"]
        rows[f"{curve_name}.{mode}"] = {
            "kernel": kernel, "walls_s": walls[(curve_name, mode)],
            "verifies_per_s": MODE_BATCH / wall, "prep_s": prep_s,
            "kernel_ms": kernel_ms,
            "kernel_share_of_wall": kernel_ms / 1e3 / wall}
    traced = {}
    for mode in ("halfgcd", "windowed"):
        got, wall, busy, kernel_s = traced_device_window(
            lambda mode=mode: wc.verify_batch(_curve("secp256r1"),
                                              data["secp256r1"][0],
                                              mode=mode, device=dev))
        if list(got) != data["secp256r1"][1]:
            raise SystemExit(f"traced secp256r1 {mode} verdicts disagree "
                             "with the construction")
        traced[mode] = {"wall_s": wall, "busy_s": busy, "kernel_s": kernel_s,
                        "idle_share": idle_share(busy, wall)}
    win, hg = rows["secp256r1.windowed"], rows["secp256r1.halfgcd"]
    out = {"card": card, "items": MODE_BATCH,
           "tampered": data["secp256k1"][1].count(False), "modes": rows,
           "r1_windowed_vs_halfgcd": {
               "windowed_verifies_per_s": win["verifies_per_s"],
               "halfgcd_verifies_per_s": hg["verifies_per_s"],
               "windowed_over_halfgcd": (win["verifies_per_s"]
                                         / hg["verifies_per_s"]),
               "windowed_prep_s": win["prep_s"],
               "halfgcd_prep_s": hg["prep_s"],
               "windowed_kernel_ms": win["kernel_ms"],
               "halfgcd_kernel_ms": hg["kernel_ms"],
               "traced": traced}}
    return out, {n: c for n, c in launches.items()
                 if n.removesuffix(f"_{MODE_SMALL}") in MODE_KERNELS.values()}


def traced_window(batcher_factory, groups, want):
    """Run ``groups`` (lists of checks) once more under torch.profiler and
    return (wall s, busy s, kernel s) of the window from the trace, traced
    again (up to TRACE_ATTEMPTS sessions) while the trace holds no kernel;
    busy and kernel s are None when every session misses."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with tempfile.TemporaryDirectory() as prof_dir:
            os.environ["CORDA_TPU_PROFILE_DIR"] = prof_dir
            try:
                batcher = batcher_factory()
                t0 = time.perf_counter()
                futs = [batcher.submit_group(g) for g in groups]
                got = [f.result(timeout=900) for f in futs]
                wall = time.perf_counter() - t0
                batcher.close()
            finally:
                del os.environ["CORDA_TPU_PROFILE_DIR"]
            (trace,) = glob.glob(os.path.join(prof_dir,
                                              "sig-batcher-*.json"))
            busy_s, kernel_s = device_busy_s(trace)
        if got != want:
            raise SystemExit("traced verdicts disagree with the construction")
        if kernel_s > 0.0:
            return wall, busy_s, kernel_s
        log(f"traced window {attempt}/{TRACE_ATTEMPTS}: the profiler trace "
            "holds no kernel on the card")
    log("traced window: idle share not measured")
    return wall, None, None


def mixed_transactions(seed: int, ec_data: dict, pool) -> list:
    """The mixed verify_signed run's SignedTransactions: each a
    DummyContract issuance whose id is signed by one Ed25519, one
    secp256k1 and one secp256r1 signer (``ec_data``'s keys; the ECDSA
    signatures on ``pool``), every eighth transaction's secp256r1
    signature tampered."""
    from corda_tpu_torch.core.contracts import Command, TransactionState
    from corda_tpu_torch.core.crypto import PublicKey, ecmath
    from corda_tpu_torch.core.crypto.keys import sec1_compress
    from corda_tpu_torch.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                                     ECDSA_SECP256R1_SHA256,
                                                     EDDSA_ED25519_SHA512)
    from corda_tpu_torch.core.crypto.signatures import DigitalSignatureWithKey
    from corda_tpu_torch.core.identity import Party
    from corda_tpu_torch.core.transactions import (SignedTransaction,
                                                   WireTransaction)
    from corda_tpu_torch.testing.dummy import DummyContract, DummyState
    schemes = {"secp256k1": ECDSA_SECP256K1_SHA256,
               "secp256r1": ECDSA_SECP256R1_SHA256}
    rng = random.Random(seed)
    ed_seeds = [rng.randbytes(32) for _ in range(16)]
    ed_keys = [PublicKey(EDDSA_ED25519_SHA512, ecmath.ed25519_public_key(sd))
               for sd in ed_seeds]
    notary = Party(NOTARY_NAME, PublicKey(
        EDDSA_ED25519_SHA512, ecmath.ed25519_public_key(rng.randbytes(32))))
    ec_keys = {name: [PublicKey(scheme, sec1_compress(_curve(name), pt))
                      for pt in ec_data[name][2]]
               for name, scheme in schemes.items()}
    wtxs = []
    for t in range(MIXED_TXS):
        signers = (ed_keys[t % 16], ec_keys["secp256k1"][t % EC_SIGNERS],
                   ec_keys["secp256r1"][t % EC_SIGNERS])
        wtxs.append(WireTransaction(
            outputs=(TransactionState(DummyState(t, signers), notary),),
            commands=(Command(DummyContract.Create(), signers),),
            notary=notary, must_sign=signers))
    tx_sigs = [[DigitalSignatureWithKey(
        ecmath.ed25519_sign(ed_seeds[t % 16], w.id.bytes,
                            public=ed_keys[t % 16].encoded), ed_keys[t % 16])]
        for t, w in enumerate(wtxs)]
    for name in schemes:
        curve = _curve(name)
        privs = ec_data[name][1]
        jobs = [(name, privs[t % EC_SIGNERS], wtxs[t].id.bytes)
                for t in range(MIXED_TXS)]
        for t, (r, s) in enumerate(pool.map(_ecdsa_sign_job, jobs,
                                            chunksize=16)):
            if name == "secp256r1" and t % 8 == 3:
                s = s + 1 if s + 1 <= curve.n // 2 else s - 1
            tx_sigs[t].append(DigitalSignatureWithKey(
                ecmath.ecdsa_sig_to_der(r, s), ec_keys[name][t % EC_SIGNERS]))
    return [SignedTransaction.of(w, sg) for w, sg in zip(wtxs, tx_sigs)]


class SmokeServices:
    """The services a SignedTransaction resolves against: states and
    attachments in dicts."""

    def __init__(self, states=None, attachments=None):
        self.states = dict(states or {})
        self.blobs = dict(attachments or {})
        self.attachments = self

    def load_state(self, ref):
        return self.states.get(ref)

    def open_attachment(self, att_id):
        return self.blobs.get(att_id)


def pump_until(bus, futures) -> None:
    """Pump the in-memory bus until every future is done: the workers
    reply from their pool threads, so replies land between pumps."""
    deadline = time.monotonic() + OOP_DEADLINE_S
    while not all(f.done() for f in futures):
        bus.run_network()
        time.sleep(0.001)
        if time.monotonic() > deadline:
            raise SystemExit("oop: verifications did not complete within "
                             f"{OOP_DEADLINE_S} s")


def tx_outcomes(futures) -> list[bool]:
    """True for a future that resolved None, False for one that failed on a
    signature; any other failure raises."""
    out = []
    for f in futures:
        try:
            f.result(timeout=0)
            out.append(True)
        except Exception as exc:   # the outcome under test
            if (type(exc).__name__ != "TransactionVerificationException"
                    or "did not verify" not in str(exc)):
                raise
            out.append(False)
    return out


def oop_phase(card, stxs, tx_want, ed_base, bulk, bulk_want,
              mixed_tx_per_s: float, direct_verifies_per_s: float) -> dict:
    """Phase 7b: make_verifier_service("OutOfProcess") over an in-memory bus,
    its workers' SignatureBatcher(device="cuda", host_crossover=0) on the
    card: the mixed transactions through verify_signed, Ed25519 bulk groups
    through verify_signatures, and a worker's death before the bus is
    pumped."""
    from corda_tpu_torch.core.crypto import PublicKey
    from corda_tpu_torch.core.crypto.schemes import EDDSA_ED25519_SHA512
    from corda_tpu_torch.network import InMemoryMessagingNetwork
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import weierstrass as wc
    from corda_tpu_torch.verifier import (SignatureBatcher, VerifierWorker,
                                          make_verifier_service)

    def fleet(n_workers: int):
        bus = InMemoryMessagingNetwork()
        svc = make_verifier_service("OutOfProcess",
                                    network_service=bus.create_node("node"))
        workers = [VerifierWorker(
            bus.create_node(f"w{i}"), "node", device_shard=(0,),
            batcher=SignatureBatcher(device="cuda", host_crossover=0))
            for i in range(n_workers)]
        bus.run_network()
        if svc.queue.worker_count != n_workers:
            raise SystemExit(f"oop: {svc.queue.worker_count} of {n_workers} "
                             "workers attached")
        return bus, svc, workers

    def zero_launches():
        ed.verify_core_split.launches = 0
        wc.verify_core_hybrid_wide.launches = 0
        wc.verify_core_r1_split.launches = 0

    def launches():
        return {"ed25519": ed.verify_core_split.launches,
                "secp256k1": wc.verify_core_hybrid_wide.launches,
                "secp256r1": wc.verify_core_r1_split.launches}

    services = SmokeServices()
    # 1. the mixed transactions through one worker
    bus, svc, (worker,) = fleet(1)
    zero_launches()
    t0 = time.perf_counter()
    futs = [svc.verify_signed(stx, services) for stx in stxs]
    pump_until(bus, futs)
    mixed_s = time.perf_counter() - t0
    mixed_launches = launches()
    if tx_outcomes(futs) != tx_want:
        raise SystemExit("oop: verify_signed outcomes disagree with the "
                         "construction")
    batcher = worker.batcher
    require_clean(batcher.metrics.snapshot(), batcher.breaker_status(),
                  3 * len(stxs), "oop verify_signed")
    if 0 in mixed_launches.values():
        raise SystemExit("oop: the worker launched a kernel no time: "
                         f"{mixed_launches}")

    # 2. Ed25519 bulk groups: one untampered, one with the service phase's
    # tampering (it fails with the first bad key's message)
    clean = [(PublicKey(EDDSA_ED25519_SHA512, p), s, m) for p, s, m in
             (ed_base[i % len(ed_base)] for i in range(OOP_BULK))]
    first_bad = bulk[bulk_want.index(False)][0]
    want_msg = f"Signature by {first_bad.to_string_short()} did not verify"
    zero_launches()
    t0 = time.perf_counter()
    futs = [svc.verify_signatures(clean), svc.verify_signatures(bulk)]
    pump_until(bus, futs)
    bulk_s = time.perf_counter() - t0
    bulk_launches = launches()["ed25519"]
    if futs[0].result(timeout=0) is not None:
        raise SystemExit("oop: the untampered group did not resolve None")
    try:
        futs[1].result(timeout=0)
        raise SystemExit("oop: the tampered group resolved None")
    except Exception as exc:   # the outcome under test
        if (type(exc).__name__ != "TransactionVerificationException"
                or not str(exc).startswith(want_msg)):
            raise SystemExit(f"oop: the tampered group failed with {exc!r}, "
                             f"not {want_msg!r}")
    snap = batcher.metrics.snapshot()
    breakers = batcher.breaker_status()
    require_clean(snap, breakers, 3 * len(stxs) + 2 * OOP_BULK, "oop bulk")
    if bulk_launches == 0:
        raise SystemExit("oop: the bulk groups launched B2 no time")
    status = svc.fleet_status()
    counts = svc.metrics.snapshot()
    worker.stop()
    svc.shutdown()
    out = {
        "card": card,
        "mixed_txs": len(stxs), "oop_mixed_wall_s": mixed_s,
        "oop_mixed_tx_per_s": len(stxs) / mixed_s,
        "mixed_tx_per_s": mixed_tx_per_s,
        "oop_mixed_kernel_launches": mixed_launches,
        "oop_bulk_groups": 2, "oop_bulk_items": 2 * OOP_BULK,
        "oop_bulk_wall_s": bulk_s,
        "oop_bulk_verifies_per_s": 2 * OOP_BULK / bulk_s,
        "direct_bulk_verifies_per_s": direct_verifies_per_s,
        "oop_bulk_kernel_launches": bulk_launches,
        "tampered_group_error": want_msg,
        "worker_verified": worker.verified_count,
        "worker_processed_sigs": worker.processed_sig_count,
        "device_checked": count(snap, "SigBatcher.DeviceChecked"),
        "device_batches": count(snap, "SigBatcher.DeviceBatches"),
        "host_routed": count(snap, "SigBatcher.HostRouted"),
        "batch_failures": count(snap, "SigBatcher.BatchFailure"),
        "breakers": {k: v["state"] for k, v in breakers.items()},
        "verification_success": count(counts, "Verification.Success"),
        "verification_failure": count(counts, "Verification.Failure"),
        "fleet_status": status,
    }

    # 3. redistribution on a worker's death, on the card
    bus, svc, (dead, alive) = fleet(2)
    zero_launches()
    futs = [svc.verify_signed(stx, services)
            for stx in stxs[:OOP_DEATH_TXS]]
    dead.stop(announce=False)
    svc.queue.detach_worker("w0")
    pump_until(bus, futs)
    if tx_outcomes(futs) != tx_want[:OOP_DEATH_TXS]:
        raise SystemExit("oop: outcomes after a worker's death disagree "
                         "with the construction")
    rlog = svc.request_log
    terminal = [rlog.terminal_count(vid) for vid in
                range(1, OOP_DEATH_TXS + 1)]
    requeued = sum("requeued" in rlog.events(vid)
                   for vid in range(1, OOP_DEATH_TXS + 1))
    counts = svc.metrics.snapshot()
    resolved = (count(counts, "Verification.Success")
                + count(counts, "Verification.Failure"))
    if terminal != [1] * OOP_DEATH_TXS or resolved != OOP_DEATH_TXS:
        raise SystemExit("oop: a future did not resolve exactly once "
                         f"({resolved} resolved, terminal {terminal})")
    if dead.verified_count != 0 or alive.verified_count != OOP_DEATH_TXS \
            or requeued == 0:
        raise SystemExit(f"oop: the dead worker verified "
                         f"{dead.verified_count}, the survivor "
                         f"{alive.verified_count}, {requeued} requeued")
    require_clean(alive.batcher.metrics.snapshot(),
                  alive.batcher.breaker_status(), 3 * OOP_DEATH_TXS,
                  "oop after a worker's death")
    death_launches = launches()
    alive.stop()
    svc.shutdown()
    out["death"] = {"txs": OOP_DEATH_TXS, "requeued": requeued,
                    "dead_verified": dead.verified_count,
                    "alive_verified": alive.verified_count,
                    "kernel_launches": death_launches}
    return out


# ---------------------------------------------------------------------------
# B6: SHA-256 / Merkle
# ---------------------------------------------------------------------------

def _host_root(leaves: bytes) -> bytes:
    """hashlib Merkle root of concatenated 32-byte leaves (a power of two
    of them)."""
    import hashlib
    level = [leaves[i:i + 32] for i in range(0, len(leaves), 32)]
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
    return level[0]


def compare_b6(label, shape, kernel, plain, arg, host_check, ops, nbytes,
               card, plain_runs):
    """One B6 shape: the kernel against its plain version on the same
    tensor (bit-identical words), ``host_check`` on the kernel's words
    (hashlib on a random 256 lanes), and both versions' times. A B6 call
    is tens of microseconds on the card, about what the Python wrapper
    takes to issue it, so its time is taken over B6_TIMED_CALLS calls
    issued back to back between the two events."""
    import numpy as np
    import torch
    from corda_tpu_torch.ops import sha256 as sha
    k = sha.words_to_numpy(kernel(arg))
    p = sha.words_to_numpy(plain(arg))
    torch.cuda.synchronize()
    if not np.array_equal(k, p):
        raise SystemExit(f"{label} disagrees with its plain version at "
                         f"{shape}: {(k != p).any(axis=-1).sum()} digests")
    host_check(k)

    def launches():
        for _ in range(B6_TIMED_CALLS):
            kernel(arg)
    ms = time_cuda(launches, RUNS) / B6_TIMED_CALLS
    plain_ms = time_cuda(lambda: plain(arg), plain_runs)
    bms, by = sha_bound_ms(ops, nbytes)
    err = int(np.abs(k.astype(np.int64) - p.astype(np.int64)).max())
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "max_abs_err": err}
    log(json.dumps({"kernel": label, "shape": shape, "identical": True,
                    "hashlib_sample_agrees": True, **row, "card": card}))
    return row


def b6_kernel_phase(dev, card, seed: int) -> dict:
    """Phase 2, B6: hash_pairs, merkle_root and sha256_blocks at the
    smoke's shapes. Returns {(function, shape): row}."""
    import hashlib
    import numpy as np
    from corda_tpu_torch.ops import sha256 as sha
    rng = np.random.default_rng(seed)
    pick = random.Random(seed)
    rows = {}

    def words(*shape):
        return sha.as_words(rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                            .astype(np.uint32)).to(dev)

    for n in PAIR_SIZES:
        arg = words(n, 16)
        raw = sha.words_to_numpy(arg).astype(">u4").tobytes()

        def check(k, n=n, raw=raw):
            got = k.astype(">u4").tobytes()
            for i in pick.sample(range(n), min(n, ORACLE_SAMPLE)):
                if got[32 * i:32 * i + 32] != hashlib.sha256(
                        raw[64 * i:64 * i + 64]).digest():
                    raise SystemExit(f"hash_pairs lane {i} of {n} differs "
                                     "from hashlib")
        rows[("hash_pairs", n)] = compare_b6(
            "sha256_hash_pairs", n, sha.hash_pairs, sha.hash_pairs_plain, arg,
            check, n * SHA_PAIR_OPS, n * 96, card, 3)
    for trees, leaves in ROOT_SHAPES:
        arg = words(trees, leaves, 8) if trees > 1 else words(leaves, 8)
        raw = sha.words_to_numpy(arg).astype(">u4").tobytes()

        def check(k, trees=trees, leaves=leaves, raw=raw):
            got = k.reshape(-1, 8).astype(">u4").tobytes()
            size = 32 * leaves
            for i in pick.sample(range(trees), min(trees, ORACLE_SAMPLE)):
                if got[32 * i:32 * i + 32] != _host_root(
                        raw[size * i:size * (i + 1)]):
                    raise SystemExit(f"merkle_root tree {i} of {trees}x"
                                     f"{leaves} differs from hashlib")
        rows[("merkle_root", (trees, leaves))] = compare_b6(
            "sha256_merkle_root", [trees, leaves], sha.merkle_root,
            sha.merkle_root_plain, arg, check,
            trees * (leaves - 1) * SHA_PAIR_OPS, trees * (leaves + 1) * 32,
            card, 2 if leaves > 16 else 3)
    for n, n_blocks in BLOCK_SHAPES:
        lo, hi = 64 * (n_blocks - 1), 64 * n_blocks - 9
        msgs = [rng.bytes(int(rng.integers(lo, hi + 1))) for _ in range(n)]
        arg = sha.as_words(sha.pack_batch(msgs)).to(dev)

        def check(k, msgs=msgs):
            got = k.astype(">u4").tobytes()
            for i in pick.sample(range(len(msgs)), ORACLE_SAMPLE):
                if got[32 * i:32 * i + 32] != hashlib.sha256(
                        msgs[i]).digest():
                    raise SystemExit(f"sha256_blocks message {i} differs "
                                     "from hashlib")
        rows[("sha256_blocks", (n, n_blocks))] = compare_b6(
            "sha256_blocks", [n, n_blocks], sha.sha256_blocks,
            sha.sha256_blocks_plain, arg, check, n * n_blocks * SHA_BLOCK_OPS,
            n * (64 * n_blocks + 32), card, 3)
    return rows


def _oracle_wtx(env, i: int):
    """Oracle-shaped: one DummyState output, a Create and a Fix command,
    notary, two must_sign keys and the type (7 components)."""
    C, O = env["contracts"], env["oracle"]
    return env["WireTransaction"](
        outputs=(C.TransactionState(env["DummyState"](i + 1, (env["alice"],)),
                                    env["notary"]),),
        commands=(C.Command(env["DummyContract"].Create(), (env["alice"],)),
                  C.Command(O.Fix(O.FixOf("ICE LIBOR", "2016-03-16", "3M"),
                                  400 + i), (env["rates"],))),
        notary=env["notary"], must_sign=(env["alice"], env["rates"]))


def _cash_wtx(env, i: int):
    """Cash-shaped: three inputs, two outputs, a Move command, notary and
    three must_sign keys (the two owners and the notary) and the type (11
    components)."""
    C = env["contracts"]
    owners = (env["alice"], env["bob"])
    return env["WireTransaction"](
        inputs=tuple(C.StateRef(env["SecureHash"].sha256(
            f"prev {i} {k}".encode()), k) for k in range(3)),
        outputs=tuple(C.TransactionState(
            env["DummyState"](100 * i + k, (owners[k],)), env["notary"])
            for k in range(2)),
        commands=(C.Command(env["DummyContract"].Move(), owners),),
        notary=env["notary"], must_sign=owners + (env["notary_key"],))


def traced_device_window(fn, attempts: int = TRACE_ATTEMPTS):
    """Run ``fn`` once more under torch.profiler (one session over every
    thread, as the batcher's CORDA_TPU_PROFILE_DIR session); returns (its
    result, wall s, busy s, kernel s) of the window from the exported
    trace; busy and kernel s are None when ``attempts`` sessions in a row
    hold no kernel."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       experimental_config=torch.profiler
                       ._ExperimentalConfig(profile_all_threads=True))
        with tempfile.TemporaryDirectory() as prof_dir:
            prof.start()
            try:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                prof.stop()
            trace = os.path.join(prof_dir, "window.json")
            prof.export_chrome_trace(trace)
            busy_s, kernel_s = device_busy_s(trace)
            if kernel_s > 0.0:
                return out, wall, busy_s, kernel_s
            cats = collections.Counter(e.get("cat", "") for e in json.load(
                open(trace))["traceEvents"])
        log(f"traced window {attempt}/{attempts}: the profiler trace "
            f"holds no kernel on the card; its events by category: "
            f"{dict(cats)}")
    log("traced window: idle share not measured")
    return out, wall, None, None


def merkle_phase(dev, card, seed: int) -> tuple[dict, dict]:
    """Phase 4: the Merkle path through verify_filtered_batch and
    batch_roots at the default crossover (their default device, the
    card), and one round timed on both routes on ``dev``. Returns
    (results, launches)."""
    import hashlib
    import statistics as stats
    import torch
    from corda_tpu_torch.core import contracts
    from corda_tpu_torch.core.crypto import PublicKey, SecureHash, ecmath
    from corda_tpu_torch.core.crypto.schemes import EDDSA_ED25519_SHA512
    from corda_tpu_torch.core.identity import Party
    from corda_tpu_torch.core.transactions import (FilteredTransaction,
                                                   WireTransaction)
    from corda_tpu_torch.core.transactions import batch_merkle as bm
    from corda_tpu_torch.ops import sha256 as sha
    from corda_tpu_torch.samples import rates_oracle
    from corda_tpu_torch.testing.dummy import DummyContract, DummyState

    rng = random.Random(seed)
    keys = [PublicKey(EDDSA_ED25519_SHA512,
                      ecmath.ed25519_public_key(rng.randbytes(32)))
            for _ in range(4)]
    env = {"contracts": contracts, "oracle": rates_oracle,
           "WireTransaction": WireTransaction, "DummyState": DummyState,
           "DummyContract": DummyContract, "SecureHash": SecureHash,
           "alice": keys[0], "rates": keys[1], "bob": keys[2],
           "notary_key": keys[3], "notary": Party(NOTARY_NAME, keys[3])}
    out = {"card": card, "device_crossover": bm.DEVICE_CROSSOVER}

    t0 = time.perf_counter()
    owtx = [_oracle_wtx(env, i) for i in range(MERKLE_DISTINCT)]
    cwtx = [_cash_wtx(env, i) for i in range(MERKLE_DISTINCT)]
    olists = [w.available_component_hashes for w in owtx]
    clists = [w.available_component_hashes for w in cwtx]

    def reveals_fix(c):
        return (isinstance(c, contracts.Command)
                and isinstance(c.value, rates_oracle.Fix))
    base = [w.build_filtered_transaction(reveals_fix) for w in owtx]
    ftxs, want = [], []
    for i in range(MERKLE_DISTINCT * PROOF_TILE):
        ftx = base[i % MERKLE_DISTINCT]
        if i % 16 == 5:          # 1/16 tampered: wrong root or swapped leaf
            other = base[(i + 1) % MERKLE_DISTINCT]
            ftx = (FilteredTransaction(SecureHash.sha256(b"wrong %d" % i),
                                       ftx.filtered_leaves,
                                       ftx.partial_merkle_tree)
                   if (i // 16) % 2 == 0 else
                   FilteredTransaction(ftx.root_hash, other.filtered_leaves,
                                       ftx.partial_merkle_tree))
        ftxs.append(ftx)
        want.append(i % 16 != 5)
    lists = [olists[i % MERKLE_DISTINCT]
             for i in range(MERKLE_DISTINCT * ROOT_TILE)] + [
        clists[i % MERKLE_DISTINCT]
        for i in range(MERKLE_DISTINCT * ROOT_TILE)]
    ids = [owtx[i % MERKLE_DISTINCT].id.bytes
           for i in range(MERKLE_DISTINCT * ROOT_TILE)] + [
        cwtx[i % MERKLE_DISTINCT].id.bytes
        for i in range(MERKLE_DISTINCT * ROOT_TILE)]
    out["dataset_s"] = time.perf_counter() - t0
    log(f"merkle dataset: {2 * MERKLE_DISTINCT} transactions, "
        f"{len(ftxs)} tear-offs, {len(lists)} id lists in "
        f"{out['dataset_s']:.1f} s")

    def both_routes(call, counter):
        """``call`` on the host route and on the card in turns (host,
        card, card, host): (results, host s, card s, launches of the
        first card run, counted from 0 just before it)."""
        results, host_s, dev_s, launches = [], [], [], None
        for use_device in (False, True, True, False):
            if use_device and launches is None:
                counter.launches = 0
            t0 = time.perf_counter()
            results.append(call(use_device))
            torch.cuda.synchronize()
            (dev_s if use_device else host_s).append(
                time.perf_counter() - t0)
            if use_device and launches is None:
                launches = counter.launches
        return results, host_s, dev_s, launches

    # bulk tear-off verification
    results, host_s, dev_s, pair_launches = both_routes(
        lambda d: bm.verify_filtered_batch(ftxs, use_device=d),
        sha.hash_pairs)
    if any(r != want for r in results):
        raise SystemExit("verify_filtered_batch verdicts disagree with the "
                         "construction")
    if pair_launches == 0:
        raise SystemExit("verify_filtered_batch launched hash_pairs no time")
    _, tr_wall, tr_busy, tr_kernel = traced_device_window(
        lambda: bm.verify_filtered_batch(ftxs))
    out["proofs"] = {
        "n": len(ftxs), "tampered": want.count(False),
        "host_s": host_s, "device_s": dev_s,
        "host_proofs_per_s": len(ftxs) / stats.median(host_s),
        "device_proofs_per_s": len(ftxs) / stats.median(dev_s),
        "hash_pairs_launches": pair_launches,
        "traced_wall_s": tr_wall, "traced_device_busy_s": tr_busy,
        "traced_kernel_s": tr_kernel,
        "traced_device_idle_share": idle_share(tr_busy, tr_wall)}

    # bulk transaction ids
    results, host_s, dev_s, root_launches = both_routes(
        lambda d: [h.bytes for h in bm.batch_roots(lists, use_device=d)],
        sha.merkle_root)
    if any(r != ids for r in results):
        raise SystemExit("batch_roots disagrees with WireTransaction.id")
    if root_launches == 0:
        raise SystemExit("batch_roots launched merkle_root no time")
    _, tr_wall, tr_busy, tr_kernel = traced_device_window(
        lambda: bm.batch_roots(lists))
    out["roots"] = {
        "n": len(lists), "leaves": [8, 16],
        "host_s": host_s, "device_s": dev_s,
        "host_roots_per_s": len(lists) / stats.median(host_s),
        "device_roots_per_s": len(lists) / stats.median(dev_s),
        "merkle_root_launches": root_launches,
        "traced_wall_s": tr_wall, "traced_device_busy_s": tr_busy,
        "traced_kernel_s": tr_kernel,
        "traced_device_idle_share": idle_share(tr_busy, tr_wall)}

    # one round on both routes, as verify_filtered_batch runs it
    curve = []
    for n in CROSSOVER_SIZES:
        pairs = rng.randbytes(64 * n)

        def host_round():
            return [hashlib.sha256(pairs[i * 64:(i + 1) * 64]).digest()
                    for i in range(n)]

        def device_round():
            arr = sha.as_words(bm._words(pairs, n, 16)).to(dev)
            return sha.digests_to_bytes(sha.hash_pairs(arr))
        if device_round() != host_round():
            raise SystemExit(f"round of {n} pairs: routes disagree")
        t_host, t_dev = [], []
        for _ in range(5):
            t1 = time.perf_counter()
            host_round()
            t_host.append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            device_round()
            t_dev.append(time.perf_counter() - t1)
        curve.append({"pairs": n, "host_ms": 1e3 * stats.median(t_host),
                      "device_ms": 1e3 * stats.median(t_dev)})
    faster = [c["pairs"] for c in curve if c["device_ms"] < c["host_ms"]]
    out["round_curve"] = curve
    out["measured_crossover_pairs"] = min(faster) if faster else None
    return out, {"sha256_hash_pairs": pair_launches,
                 "sha256_merkle_root": root_launches}


# ---------------------------------------------------------------------------
# B7 (Ed25519 Shamir and windowed ladders) and B10 (SIMM margin)
# ---------------------------------------------------------------------------

def b7_batch(base, seed: int):
    """B7_DISTINCT adversarial items: ``base`` tiled with 1/16 tampered
    (non-canonical R y, s >= L, undecodable key among the seven kinds),
    plus an undecodable R (y = 2) at three fixed places. Returns (items,
    want)."""
    items, want = tile(base, B7_DISTINCT, seed)
    for pos in (9, B7_DISTINCT // 2 + 9, B7_DISTINCT - 3):
        pub, sig, msg = items[pos]
        items[pos] = (pub, (2).to_bytes(32, "little") + sig[32:], msg)
        want[pos] = False
    return items, want


#: Batch axis of each B7 prep array (tuples: point coordinates).
B7_AXES = {"ed25519_shamir_verify": (1, 1, (0,) * 4, (0,) * 2, 0),
           "ed25519_windowed_verify": (1, 2, (0,) * 4, 0, 0, 0)}


def b7_preps(ed, items) -> dict:
    """Each B7 kernel's host prep of ``items``, once."""
    return {"ed25519_shamir_verify": ed.prepare_batch(items),
            "ed25519_windowed_verify": ed.prepare_batch_windowed(
                items, device_tables=False)}


def take_batch(arrays, axes, n: int):
    """The first ``n`` items of a prep, tiled past its length."""
    import numpy as np

    def one(a, ax):
        if isinstance(ax, tuple):
            return tuple(one(c, x) for c, x in zip(a, ax))
        idx = np.arange(n) % a.shape[ax]
        return np.ascontiguousarray(np.take(a, idx, axis=ax))
    return tuple(one(a, ax) for a, ax in zip(arrays, axes))


def b7_case(ed, name: str, prep, want, n: int, dev):
    """Phase 2 inputs of a B7 kernel at bucket ``n``: (dispatcher, plain
    version, device wire tensors, tables, table bytes, precheck, want)."""
    import numpy as np
    *wire, precheck = take_batch(prep, B7_AXES[name], n)
    args = ed.b7_to_device(wire, dev)
    wantn = [want[i % len(want)] for i in range(n)]
    if KERNELS[name]["ladder"] == "shamir":
        return (ed.verify_core, ed.verify_core_plain, args, (), 0, precheck,
                wantn)
    rows = np.unique(wire[0]).size
    return (ed.verify_core_windowed, ed.verify_core_windowed_plain, args,
            ed.windowed_table(dev), rows * NIELS_ROW_BYTES, precheck, wantn)


def hold_b7_lanes(ed, name, prep, want, sizes, timed, dev, card) -> None:
    """A B7 library's two kernels, each forced through the launcher's lanes
    argument whatever its threshold picks, against the plain version at
    each of ``sizes`` (raw bit-identity and the masked verdicts; no launch
    counted), and its dispatcher at the threshold +-1 (B7_THRESHOLD: the
    lanes it picks there logged from its counts); at the sizes of
    ``timed`` also both kernels' CUDA-event medians in turns (1, 2, 2, 1
    lanes), which set the threshold."""
    import torch
    from corda_tpu_torch.ops import _cuda as cu
    if KERNELS[name]["ladder"] == "shamir":
        lib, plain, tabs = ed.load_shamir_kernel(), ed.verify_core_plain, ()
        dispatcher = ed.verify_core
    else:
        lib, plain = ed.load_windowed_kernel(), ed.verify_core_windowed_plain
        tabs = ed.windowed_table(dev)
        dispatcher = ed.verify_core_windowed
    dispatched = {}
    for n in sizes:
        *wire, precheck = take_batch(prep, B7_AXES[name], n)
        dargs = ed.b7_to_device(wire, dev)
        args = (*ed.b7_flat(dargs), *tabs)
        p = plain(*dargs, *tabs).cpu().numpy()
        wantn = [want[i % len(want)] for i in range(n)]
        runs = {f"{lanes} lane(s)": lambda lanes=lanes: cu.launch_verify(
            lib, name, args, n, dev, lanes) for lanes in (1, 2)}
        if n in B7_THRESHOLD:
            runs["the dispatcher"] = lambda: dispatcher(*dargs, *tabs)
            before = dict(dispatcher.launches_by_lanes)
        for label, run in runs.items():
            ok = run()
            torch.cuda.synchronize()
            k = ok.cpu().numpy()
            if not (k == p).all():
                raise SystemExit(f"{name} on {label} disagrees with its "
                                 f"plain version at {n} items: "
                                 f"{(k != p).sum()} verdicts")
            if list(k & precheck) != wantn:
                raise SystemExit(f"{name} on {label} disagrees with the "
                                 f"construction at {n} items")
        if n in B7_THRESHOLD:
            dispatched[n] = [k for k, v in dispatcher.launches_by_lanes.items()
                             if v != before[k]]
        if n in timed:
            runs = {1: [], 2: []}
            for lanes in (1, 2, 2, 1):
                runs[lanes].append(time_cuda(
                    lambda lanes=lanes: cu.launch_verify(lib, name, args, n,
                                                         dev, lanes), RUNS))
            log(json.dumps({"kernel": name, "items": n, "lanes_ms": {
                k: statistics.median(r) for k, r in runs.items()},
                "lanes_ms_runs": runs, "card": card}))
    log(json.dumps({"kernel": name, "forced_lanes": [1, 2],
                    "raw_identical_at": list(sizes),
                    "wrapper_lanes": [kernel_geometry(name, n)["lanes"]
                                      for n in sizes],
                    "dispatcher_lanes": dispatched, "card": card}))


def simm_book(simm, n: int, seed: int):
    """The demo book at 16 trades, a seeded one otherwise."""
    return simm.demo_portfolio() if n == 16 else simm.demo_portfolio(n, seed)


def exact_margin(simm, book) -> float:
    """The book's margin in float64 (the reference model on the host)."""
    import numpy as np
    ws = simm.RISK_WEIGHTS.astype(np.float64) * book.astype(
        np.float64).sum(axis=0)
    return float(np.sqrt(ws @ simm.correlation_matrix().astype(
        np.float64) @ ws))


def _b10_trace_job(job) -> float | None:
    """In a fresh process: B6_TIMED_CALLS margin calls on a book of ``n``
    trades (``simm_book(n, seed)``) on the card, once to load and warm up,
    then once under torch.profiler; returns the window's kernel seconds, or
    None when its trace holds no kernel."""
    n, seed = job
    import torch
    from corda_tpu_torch.samples import simm_valuation as simm
    dev = torch.device("cuda", 0)
    rw, corr = simm.model_tensors(dev)
    sens = torch.from_numpy(simm_book(simm, n, seed)).to(dev)

    def run():
        for _ in range(B6_TIMED_CALLS):
            simm.margin(sens, rw, corr)
    run()
    torch.cuda.synchronize()
    return traced_device_window(run, attempts=1)[3]


def b10_kernel_ms(n: int, seed: int) -> float:
    """B10's kernel ms a call on ``n`` trades, from a torch.profiler window
    traced in a fresh process (another one while the trace holds no
    kernel, up to TRACE_ATTEMPTS); exits non-zero when none holds one."""
    ctx = multiprocessing.get_context("spawn")
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
            kernel_s = pool.submit(_b10_trace_job, (n, seed)).result(
                timeout=600)
        if kernel_s:
            return 1e3 * kernel_s / B6_TIMED_CALLS
        log(f"simm_margin at {n} trades: fresh process {attempt}/"
            f"{TRACE_ATTEMPTS} traced no kernel")
    raise SystemExit(f"simm_margin at {n} trades: no traced window of "
                     f"{TRACE_ATTEMPTS} fresh processes holds a kernel")


def b10_kernel_phase(dev, card, seed: int) -> dict:
    """Phase 2, B10: the margin kernel against its plain version on the
    same tensors at SIMM_SIZES trades — relative difference at most 1e-5,
    and up to 1024 trades at most 2 cents; the kernel rounds as the plain
    version does, so the two must be equal bit for bit; the same result on
    a second launch (no atomics); within 1e-5 of the float64 margin.
    ``ms`` is the card's time in the kernel's passes: the kernel time of a
    torch.profiler window of B6_TIMED_CALLS calls over the calls, traced in
    a fresh process (b10_kernel_ms; the window launches no other kernel).
    ``issue_ms`` is
    the CUDA-event time of back-to-back wrapper calls (a call is tens of
    microseconds, so the host's issue of it shows there); the plain
    version's and torch.sum(sens, 0)'s are timed likewise."""
    import torch
    from corda_tpu_torch.samples import simm_valuation as simm
    rw, corr = simm.model_tensors(dev)
    rows, worst = {}, {"abs_dollars": 0.0, "rel": 0.0}
    for n in SIMM_SIZES:
        book = simm_book(simm, n, seed + n)
        sens = torch.from_numpy(book).to(dev)
        k = simm.margin(sens, rw, corr)
        p = simm.margin_plain(sens, rw, corr)
        torch.cuda.synchronize()
        kv, pv = float(k), float(p)
        diff = abs(kv - pv)
        rel = diff / pv
        if rel > 1e-5:
            raise SystemExit(f"simm_margin at {n} trades: relative "
                             f"difference {rel} > 1e-5")
        if n <= 1024 and 100 * diff > 2.0:
            raise SystemExit(f"simm_margin at {n} trades: {100 * diff} "
                             "cents from its plain version")
        if k.cpu().numpy().tobytes() != p.cpu().numpy().tobytes():
            raise SystemExit(f"simm_margin at {n} trades: {kv} is not its "
                             f"plain version's {pv} bit for bit")
        if float(simm.margin(sens, rw, corr)) != kv:
            raise SystemExit(f"simm_margin at {n} trades differs between "
                             "two launches")
        exact = exact_margin(simm, book)
        if abs(kv - exact) > 1e-5 * exact:
            raise SystemExit(f"simm_margin at {n} trades: {kv} against the "
                             f"float64 margin {exact}")
        worst["abs_dollars"] = max(worst["abs_dollars"], diff)
        worst["rel"] = max(worst["rel"], rel)

        def calls(fn):
            def run():
                for _ in range(B6_TIMED_CALLS):
                    fn()
            return run
        issue_ms = time_cuda(calls(lambda: simm.margin(sens, rw, corr)),
                             RUNS) / B6_TIMED_CALLS
        ms = b10_kernel_ms(n, seed + n)
        plain_ms = time_cuda(calls(lambda: simm.margin_plain(sens, rw, corr)),
                             RUNS) / B6_TIMED_CALLS
        library_ms = time_cuda(calls(lambda: torch.sum(sens, 0)),
                               RUNS) / B6_TIMED_CALLS
        nbytes = n * 48 + 4 * (12 + 144) + 4
        ops = 12 * n + 2 * 144 + 3 * 12
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / FP32_PER_S
        rows[n] = {"ms": ms, "issue_ms": issue_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": 1e3 * max(bytes_s, ops_s),
                   "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                   "max_abs_err": diff, "rel_diff": rel,
                   "margin": kv, "plain_margin": pv, "float64_margin": exact}
        log(json.dumps({"kernel": B10["name"], "trades": n, **rows[n],
                        "card": card}))
    log(json.dumps({"kernel": B10["name"], "largest_difference": worst}))
    return rows


def simm_phase(dev, card, seed: int) -> tuple[dict, int]:
    """Phase 6: compute_margin_cents on the demo book and on the 2^20-trade
    book through the card (launch count set to 0 just before, read just
    after): cents within 1e-5 of the float64 margin, the demo book's within
    2 cents. Returns (results, launches)."""
    from corda_tpu_torch.samples import simm_valuation as simm
    books = {16: simm_book(simm, 16, seed),
             SIMM_SIZES[-1]: simm_book(simm, SIMM_SIZES[-1],
                                       seed + SIMM_SIZES[-1])}
    simm.margin.launches = 0
    cents, walls = {}, {}
    for n, book in books.items():
        t0 = time.perf_counter()
        cents[n] = simm.compute_margin_cents(book, device=dev)
        walls[n] = time.perf_counter() - t0
    launches = simm.margin.launches
    if launches != len(books):
        raise SystemExit(f"compute_margin_cents launched simm_margin "
                         f"{launches} times, expected {len(books)}")
    out = {"card": card}
    for n, book in books.items():
        exact = 100 * exact_margin(simm, book)
        if abs(cents[n] - exact) > max(1e-5 * exact, 2.0 if n == 16 else 0):
            raise SystemExit(f"compute_margin_cents at {n} trades: "
                             f"{cents[n]} against {exact}")
        out[str(n)] = {"cents": cents[n], "float64_cents": exact,
                       "wall_s": walls[n]}
    out["launches"] = launches
    return out, launches


# ---------------------------------------------------------------------------
# B9: the sharded path over meshes of one card
# ---------------------------------------------------------------------------

def mesh_phase(dev, card, seed: int, base, ec_base, b7) -> tuple:
    """Phase 5: corda_tpu_torch.parallel on meshes of MESH_SIZES shards of
    ``dev`` (two shards: two streams of one card). Per mesh: the three
    batch wrappers on MESH_BATCH items, equal to the construction and to
    the unsharded verify_batch; the sharded Shamir and windowed B7
    callables on one prepared batch; sharded_merkle_root on MESH_LEAVES
    leaves, equal to hashlib and to merkle_root; tx_verify_step; and a
    SignatureBatcher(mesh=...) bulk run (no host failover, every breaker
    closed). Each path's launch counts are set to 0 just before it and
    read just after. The 2-shard batcher window runs once more under
    torch.profiler for the card's idle share. Returns (results, B7
    launches by kernel name)."""
    import numpy as np
    import torch
    from corda_tpu_torch import parallel as par
    from corda_tpu_torch.core.crypto import PublicKey
    from corda_tpu_torch.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                                     ECDSA_SECP256R1_SHA256,
                                                     EDDSA_ED25519_SHA512)
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import sha256 as sha
    from corda_tpu_torch.ops import weierstrass as wc
    from corda_tpu_torch.verifier import SignatureBatcher

    t0 = time.perf_counter()
    ed_items, ed_want = tile(base, MESH_BATCH, seed)
    ec = {}
    for k, name in enumerate(("secp256k1", "secp256r1")):
        curve = _curve(name)
        items, want = tile(ec_base[name], MESH_BATCH, seed + 1 + k,
                           lambda it, kind, other, c=curve:
                           tamper_ecdsa(c, it, kind, other))
        ec[name] = (items, want, wc._items_to_words(items))
    shamir = take_batch(b7[0]["ed25519_shamir_verify"],
                        B7_AXES["ed25519_shamir_verify"], MESH_BATCH)
    windowed = take_batch(b7[0]["ed25519_windowed_verify"],
                          B7_AXES["ed25519_windowed_verify"], MESH_BATCH)
    b7_want = [b7[1][i % len(b7[1])] for i in range(MESH_BATCH)]
    rng = np.random.default_rng(seed)
    leaves = rng.integers(0, 1 << 32, (MESH_LEAVES, 8),
                          dtype=np.uint64).astype(np.uint32)
    tx_leaves = leaves[:TX_LEAVES]
    host_roots = {n: _host_root(leaves[:n].astype(">u4").tobytes())
                  for n in (MESH_LEAVES, TX_LEAVES)}
    # the unsharded results on the card
    unsharded = {"ed25519": ed.verify_batch(ed_items, device=dev)}
    for name, (items, _, _) in ec.items():
        unsharded[name] = wc.verify_batch(_curve(name), items, device=dev)
    unsharded_roots = {n: sha.digests_to_bytes(sha.merkle_root(
        sha.as_words(leaves[:n]).to(dev))[None])[0]
        for n in (MESH_LEAVES, TX_LEAVES)}
    for n, r in unsharded_roots.items():
        if r != host_roots[n]:
            raise SystemExit(f"merkle_root of {n} leaves differs from "
                             "hashlib")
    schemes = {"secp256k1": ECDSA_SECP256K1_SHA256,
               "secp256r1": ECDSA_SECP256R1_SHA256}
    ed_checks = [(PublicKey(EDDSA_ED25519_SHA512, p), s, m)
                 for p, s, m in ed_items]
    ec_checks = {name: [to_check(_curve(name), schemes[name], it)
                        for it in ec[name][0]] for name in schemes}
    out = {"card": card, "items": MESH_BATCH, "dataset_s":
           time.perf_counter() - t0, "meshes": {}}
    b7_launches = {row: 0 for name in B7_KERNELS
                   for row in (name, name + "_pairs")}

    def counted(label, counters, fn):
        """Run ``fn`` with ``counters``' launch counts (and counts by lanes
        a signature, where a wrapper keeps them) set to 0 just before and
        read just after; every one must have launched."""
        for c in counters:
            c.launches = 0
            if hasattr(c, "launches_by_lanes"):
                c.launches_by_lanes.update({1: 0, 2: 0})
        t1 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = [c.launches for c in counters]
        if 0 in got:
            raise SystemExit(f"mesh {label}: a kernel launched no time: "
                             f"{got}")
        return result, wall, got

    def count_b7(name, counter):
        """Add a B7 path's launches to its kernel's rows, by lanes a
        signature (the pairs have a row of their own)."""
        b7_launches[name] += counter.launches_by_lanes[1]
        b7_launches[name + "_pairs"] += counter.launches_by_lanes[2]

    for size in MESH_SIZES:
        mesh = par.make_mesh(devices=[dev] * size)
        row = {}
        got, wall, (n_launch,) = counted(
            "ed25519", [ed.verify_core_split],
            lambda: par.sharded_verify_batch_ed25519(mesh, ed_items))
        if list(got) != ed_want or not np.array_equal(got,
                                                      unsharded["ed25519"]):
            raise SystemExit(f"mesh {size}: sharded Ed25519 verdicts differ")
        row["ed25519"] = {"wall_s": wall, "verifies_per_s": MESH_BATCH / wall,
                          "launches": n_launch}
        for name, counter, fn in (
                ("secp256k1", wc.verify_core_hybrid_wide,
                 par.sharded_verify_batch_secp256k1_words),
                ("secp256r1", wc.verify_core_r1_split,
                 par.sharded_verify_batch_secp256r1_words)):
            items, want, words = ec[name]
            got, wall, (n_launch,) = counted(
                name, [counter], lambda fn=fn, words=words: fn(mesh, *words))
            if list(got) != want or not np.array_equal(got,
                                                       unsharded[name]):
                raise SystemExit(f"mesh {size}: sharded {name} verdicts "
                                 "differ")
            row[name] = {"wall_s": wall,
                         "verifies_per_s": MESH_BATCH / wall,
                         "launches": n_launch}
        for label, prep, counter, make in (
                ("ed25519_shamir", shamir, ed.verify_core,
                 par.sharded_ed25519_verify),
                ("ed25519_windowed", windowed, ed.verify_core_windowed,
                 par.sharded_ed25519_verify_windowed)):
            *wire, precheck = prep
            fn = make(mesh)
            ok, wall, (n_launch,) = counted(label, [counter],
                                            lambda fn=fn, wire=wire:
                                            fn(*wire).cpu().numpy())
            if list(ok & precheck) != b7_want:
                raise SystemExit(f"mesh {size}: sharded {label} verdicts "
                                 "disagree with the construction")
            count_b7(label + "_verify", counter)
            row[label] = {"wall_s": wall, "verifies_per_s": MESH_BATCH / wall,
                          "launches": n_launch}
        root, wall, (n_launch,) = counted(
            "merkle", [sha.merkle_root],
            lambda: par.sharded_merkle_root(mesh)(leaves))
        if sha.digests_to_bytes(root[None])[0] != host_roots[MESH_LEAVES]:
            raise SystemExit(f"mesh {size}: sharded Merkle root differs")
        row["merkle_root"] = {"leaves": MESH_LEAVES, "wall_s": wall,
                              "launches": n_launch}
        *wire, precheck = shamir
        step = par.tx_verify_step(mesh)
        (ok, root), wall, (n_sig, n_root) = counted(
            "tx_verify_step", [ed.verify_core, sha.merkle_root],
            lambda: step(*wire, tx_leaves))
        if (list(ok.cpu().numpy() & precheck) != b7_want
                or sha.digests_to_bytes(root[None])[0]
                != host_roots[TX_LEAVES]):
            raise SystemExit(f"mesh {size}: tx_verify_step disagrees")
        count_b7("ed25519_shamir_verify", ed.verify_core)
        row["tx_verify_step"] = {"signatures": MESH_BATCH,
                                 "leaves": TX_LEAVES, "wall_s": wall,
                                 "launches": [n_sig, n_root]}
        # the batcher's mesh backend: a warm-up group, then Ed25519 bulk
        # groups (verifies/s per mesh size); on the 2-shard mesh then one
        # secp256k1 and one secp256r1 group
        batcher = SignatureBatcher(mesh=mesh)
        batcher.submit_group(ed_checks).result(timeout=600)
        batcher.close()
        batcher = SignatureBatcher(mesh=mesh)
        runs = [("batcher", [ed_checks] * MESH_BULK_GROUPS,
                 [ed_want] * MESH_BULK_GROUPS, [ed.verify_core_split])]
        if size == MESH_SIZES[-1]:
            runs.append(("batcher_ecdsa",
                         [ec_checks[name] for name in schemes],
                         [ec[name][1] for name in schemes],
                         [wc.verify_core_hybrid_wide,
                          wc.verify_core_r1_split]))
        for label, groups, want, counters in runs:
            got, wall, n_launch = counted(
                label, counters,
                lambda groups=groups: [f.result(timeout=900) for f in
                                       [batcher.submit_group(g)
                                        for g in groups]])
            if got != want:
                raise SystemExit(f"mesh {size}: {label} verdicts disagree "
                                 "with the construction")
            n_items = sum(len(g) for g in groups)
            row[label] = {"groups": len(groups), "items": n_items,
                          "wall_s": wall, "verifies_per_s": n_items / wall,
                          "launches": n_launch}
        breakers = batcher.breaker_status()
        snap = batcher.metrics.snapshot()
        batcher.close()
        require_clean(snap, breakers,
                      sum(r["items"] for k, r in row.items()
                          if k.startswith("batcher")),
                      f"mesh {size} batcher")
        row["batcher"]["breakers"] = {k: v["state"]
                                      for k, v in breakers.items()}
        if size == MESH_SIZES[-1]:
            bulk = [ed_checks] * MESH_BULK_GROUPS
            traced_s, busy_s, kernel_s = traced_window(
                lambda: SignatureBatcher(mesh=mesh), bulk,
                [ed_want] * MESH_BULK_GROUPS)
            row["traced"] = {"wall_s": traced_s, "busy_s": busy_s,
                             "kernel_s": kernel_s,
                             "device_idle_share": idle_share(busy_s, traced_s)}
        out["meshes"][str(size)] = row
        log(json.dumps({"mesh": size, **row}))
    return out, b7_launches


def c_int_params(source: str, fn: str) -> list[str]:
    """The names of the ``int`` parameters, in order, of the C function
    ``fn`` defined in ``source`` (a .cu file's text): for a verify launcher
    ``<target>_verify(ptrs..., ok, n, [int,] stream)`` the int it takes
    between n and the stream ("lanes", "curve") or none, for
    ``<target>_occupancy`` "block" and that int. Binds each side of phase
    8 by its own launcher, whatever the commit it comes from."""
    import re
    m = re.search(rf"\bint\s+{fn}\s*\(([^)]*)\)\s*\{{", source)
    if m is None:
        raise SystemExit(f"no C function {fn} in the source")
    words = [p.split() for p in m.group(1).split(",")]
    return [w[-1] for w in words if len(w) == 2 and w[0] == "int"]


def launch_variants(lib, source: str, target: str,
                    curve_id: int | None = None) -> list[tuple]:
    """(lanes a signature, int argument) of each launch that
    ``<target>_verify`` offers, as its source (``source``) declares it:
    one a lane count, 1 and 2, where it takes the lanes; else the lanes of
    its ``<target>_lanes()`` with the curve id where it takes one, or no
    int. The one place that decides the int of a launcher, for this
    checkout's kernels and an earlier commit's."""
    ints = c_int_params(source, f"{target}_verify")
    if ints == ["lanes"]:
        return [(1, 1), (2, 2)]
    lanes = getattr(lib, f"{target}_lanes")()
    if ints == ["curve"]:
        return [(lanes, curve_id)]
    if not ints:
        return [(lanes, None)]
    raise SystemExit(f"{target}_verify takes {ints}")


def build_parent_kernels(parent: str) -> tuple[dict, dict]:
    """nvcc, all at once, on the AB_LIBS sources of an earlier commit
    (``parent``/corda_tpu_torch/csrc) into corda_tpu_torch/_build/ab/,
    logging ptxas's report of each; returns ({target: library}, {target:
    source text}), each launcher bound by the int parameters its own
    source gives it (:func:`c_int_params`)."""
    import ctypes
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import _cuda
    src = os.path.join(parent, "corda_tpu_torch", "csrc")
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs, sources = {}, {}
    for target in AB_LIBS:
        path = os.path.join(src, f"{target}.cu")
        with open(path) as f:
            sources[target] = f.read()
        out = os.path.join(out_dir, f"lib{target}-parent.so")
        procs[target] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build._NVCC_FLAGS, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for target, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"building the parent's {target} failed:\n{text}")
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "stack frame")):
                log(f"ptxas parent {target}: {line.strip()}")
        lib = ctypes.CDLL(out)
        fn = getattr(lib, f"{target}_verify")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (AB_LIBS[target] + 1)
                       + [ctypes.c_int64]
                       + [ctypes.c_int] * len(c_int_params(
                           sources[target], f"{target}_verify"))
                       + [ctypes.c_void_p])
        _cuda.bind_error_string(lib, target)
        libs[target] = lib
    return libs, sources


def ab_phase(parent: str, dev, card, seed: int, ec_base, b7,
             wanted=lambda name: True) -> dict:
    """Phase 8 (--ab): an earlier commit's B3, B5 (both curves), B7 Shamir
    and windowed, and B8 Shamir (both curves) and GLV against this
    checkout's. Kernels: at each AB_BUCKETS bucket, on phase 2's
    adversarial batches (B7: its tiled batch), every side's raw verdicts
    equal the plain version's, then CUDA-event medians in turns (forward,
    then backward); each side's launcher is bound by its own source's
    signature, and a side whose launcher takes the lanes runs as two
    sides, one lane and lane pairs, whatever its threshold picks; each
    side's lanes and warps a multiprocessor are logged with its times.
    Interactive 1k secp256k1 groups through one SignatureBatcher, the
    earlier B3 behind the wrapper or this checkout's, in AB_TURNS order
    after a warm-up; p50 and p99 per side. Only the kernels ``wanted``
    names run (the interactive groups with B3's)."""
    import torch
    from corda_tpu_torch import _build
    from corda_tpu_torch.core.crypto import ecmath
    from corda_tpu_torch.core.crypto.schemes import ECDSA_SECP256K1_SHA256
    from corda_tpu_torch.ops import _cuda as cu
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import weierstrass as wc
    from corda_tpu_torch.verifier import SignatureBatcher
    libs, sources = build_parent_kernels(parent)
    mine = {"secp256k1_hybrid": wc.load_hybrid_kernel(),
            "weierstrass_shamir": wc.load_shamir_kernel(),
            "weierstrass_windowed": wc.load_windowed_kernel(),
            "ed25519_shamir": ed.load_shamir_kernel(),
            "ed25519_windowed": ed.load_windowed_kernel(),
            "secp256k1_glv": wc.load_glv_kernel()}
    mine_src = {}
    for target in AB_LIBS:
        with open(os.path.join(_build.CSRC, f"{target}.cu")) as f:
            mine_src[target] = f.read()
    sides = {"parent": (libs, sources), "change": (mine, mine_src)}

    def variants(target, n, curve_id=None):
        """{side name: (launch(args), lanes, warps a multiprocessor)}; a
        side that offers both lane counts runs as two sides."""
        fns = {}
        for side, (side_libs, side_src) in sides.items():
            lib, source = side_libs[target], side_src[target]
            runs = launch_variants(lib, source, target, curve_id)
            for lanes, int_arg in runs:
                name = side if len(runs) == 1 else f"{side}_{lanes}_lane"
                fns[name] = (
                    lambda args, lib=lib, int_arg=int_arg: cu.launch_verify(
                        lib, f"{target}_verify", args, n, dev, int_arg),
                    lanes, launch_geometry(lib, source, target, n, lanes,
                                           int_arg)["warps_per_sm"])
        return fns
    out = {"card": card, "kernels": {}, "interactive": {}}
    for bucket in AB_BUCKETS:
        cases = {}
        for k, name in enumerate(("secp256k1", "secp256r1")):
            curve = _curve(name)
            items, _ = ecdsa_kernel_batch(curve, ec_base[name], bucket,
                                          seed + (3 + 2 * k) * bucket)
            if name == "secp256k1":
                *wire, _ = wc.prepare_batch_hybrid_wide(items)
                args = (*wc.wire_to_device(wire, dev), *wc.hybrid_tables(dev))
                cases["secp256k1_hybrid_verify"] = (
                    args, wc.verify_core_hybrid_wide_plain,
                    variants("secp256k1_hybrid", bucket))
                *wire, _ = wc.prepare_batch_glv(items)
                cases["secp256k1_glv_verify"] = (
                    wc.wire_to_device(wire, dev), wc.verify_core_glv_plain,
                    variants("secp256k1_glv", bucket))
            *wire, _ = wc.prepare_batch(curve, items)
            args = wc.wire_to_device(wire, dev)
            cases[f"{name}_shamir_verify"] = (
                args, lambda *a, name=name: wc.verify_core_plain(*a, name),
                variants("weierstrass_shamir", bucket, CURVE_IDS[name]))
            *wire, _ = wc.prepare_batch_windowed_single(curve, items)
            args = (*wc.wire_to_device(wire, dev),
                    *wc.windowed_tables(curve, dev))
            cases[f"{name}_windowed_verify"] = (
                args, lambda *a, name=name:
                wc.verify_core_windowed_single_plain(*a, name),
                variants("weierstrass_windowed", bucket, CURVE_IDS[name]))
        *wire, _ = take_batch(b7[0]["ed25519_shamir_verify"],
                              B7_AXES["ed25519_shamir_verify"], bucket)
        cases["ed25519_shamir_verify"] = (
            ed.b7_flat(ed.b7_to_device(wire, dev)),
            lambda *a: ed.verify_core_plain(a[0], a[1], a[2:6], a[6:8]),
            variants("ed25519_shamir", bucket))
        *wire, _ = take_batch(b7[0]["ed25519_windowed_verify"],
                              B7_AXES["ed25519_windowed_verify"], bucket)
        cases["ed25519_windowed_verify"] = (
            (*ed.b7_flat(ed.b7_to_device(wire, dev)),
             *ed.windowed_table(dev)),
            lambda *a: ed.verify_core_windowed_plain(a[0], a[1], a[2:6],
                                                     *a[6:]),
            variants("ed25519_windowed", bucket))
        for name, (args, plain, fns) in cases.items():
            if not wanted(name):
                continue
            want = plain(*args).cpu()
            for v, (fn, _, _) in fns.items():
                got = fn(args)
                torch.cuda.synchronize()
                if not torch.equal(got.cpu(), want):
                    raise SystemExit(f"--ab: {name} ({v}) disagrees with its "
                                     f"plain version at bucket {bucket}")
            runs = {v: [] for v in fns}
            for v in [*fns, *reversed(fns)]:
                runs[v].append(time_cuda(lambda v=v: fns[v][0](args), RUNS))
            row = {"ms": {v: statistics.median(r) for v, r in runs.items()},
                   "ms_runs": runs,
                   "lanes": {v: f[1] for v, f in fns.items()},
                   "warps_per_sm": {v: f[2] for v, f in fns.items()}}
            out["kernels"].setdefault(name, {})[bucket] = row
            log(json.dumps({"ab_kernel": name, "bucket": bucket, **row,
                            "card": card}))
    if not wanted("secp256k1_hybrid_verify"):
        return out

    curve = ecmath.SECP256K1
    items, want = tile(
        ec_base["secp256k1"], 1024, seed + 13,
        lambda it, kind, other: tamper_ecdsa(curve, it, kind, other))
    checks = [to_check(curve, ECDSA_SECP256K1_SHA256, it) for it in items]
    own = wc.verify_core_hybrid_wide_cuda

    def parent_b3(*args):
        return cu.launch_verify(libs["secp256k1_hybrid"],
                                "secp256k1_hybrid_verify", args,
                                int(args[0].shape[-1]), args[0].device)
    lat = {"parent": [], "change": []}
    batcher = SignatureBatcher(device="cuda")
    try:
        # one warm-up group a side, then the timed turns
        for warm, side in [(True, "parent"), (True, "change"),
                           *((False, t) for t in AB_TURNS)]:
            wc.verify_core_hybrid_wide_cuda = (parent_b3 if side == "parent"
                                               else own)
            for _ in range(1 if warm else INTERACTIVE_RUNS):
                t1 = time.perf_counter()
                got = batcher.submit_group(
                    checks, latency_class="interactive").result(timeout=600)
                dt = time.perf_counter() - t1
                if got != want:
                    raise SystemExit("--ab: secp256k1 interactive verdicts "
                                     f"({side}) disagree with the "
                                     "construction")
                if not warm:
                    lat[side].append(dt)
    finally:
        wc.verify_core_hybrid_wide_cuda = own
        batcher.close()
    for side, xs in lat.items():
        xs.sort()
        out["interactive"].setdefault("secp256k1", {})[side] = {
            "p50_ms": 1e3 * statistics.median(xs),
            "p99_ms": 1e3 * xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            "runs": len(xs)}
    log(json.dumps({"ab_interactive": out["interactive"], "card": card}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017,
                    help="seed of the signers, messages and tampering")
    ap.add_argument("--only-kernels", default=None, metavar="NAMES",
                    help="run phases 1 and 2 only, for the comma-separated "
                         "kernels of KERNELS named here ('all': every one), "
                         "and print no result line (a short check of "
                         "kernels on the card)")
    ap.add_argument("--ab", default=None, metavar="PARENT",
                    help="also time an earlier commit's B3, B5, B7 and B8 "
                         "kernels "
                         "(PARENT/corda_tpu_torch/csrc) against this "
                         "checkout's, and the secp256k1 interactive "
                         "latency with each B3 (phase 8)")
    args = ap.parse_args()
    if args.ab is not None and not all(os.path.isfile(os.path.join(
            args.ab, "corda_tpu_torch", "csrc", f"{target}.cu"))
            for target in AB_LIBS):
        ap.error(f"--ab: {args.ab} holds no corda_tpu_torch/csrc")
    only = (None if args.only_kernels is None else
            set(KERNELS) if args.only_kernels == "all" else
            set(args.only_kernels.split(",")))
    if only is not None and not only <= set(KERNELS):
        ap.error(f"unknown kernels: {sorted(only - set(KERNELS))}")

    def wanted(name: str) -> bool:
        return only is None or name in only

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from corda_tpu_torch import _build
    except ImportError as exc:
        print(f"chip_smoke: corda_tpu_torch is not importable ({exc}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2

    # -- phase 1: probe and build ------------------------------------------
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    nvcc = _build.nvcc_path()
    if nvcc is not None:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        log(f"nvcc: {out.splitlines()[-1] if out else 'no version'}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s wall, per library "
        f"{json.dumps(_build.BUILD_SECONDS)}")
    for lib in dict.fromkeys([k["lib"] for k in KERNELS.values()]
                             + ["sha256", B10["lib"]]):
        for line in _build.BUILD_LOG.get(lib, "").splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "stack frame")):
                log(f"ptxas {lib}: {line.strip()}")
    import numpy as np
    from corda_tpu_torch.core.crypto import ecmath
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import scalarprep
    from corda_tpu_torch.ops import weierstrass as wc
    if not scalarprep.available():
        raise SystemExit("native scalar prep is not in use")
    log("scalarprep: native")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        base = make_dataset(pool, args.seed, SIGNERS, MESSAGES)
        b7_base = make_dataset(pool, args.seed + 37, SIGNERS, B7_DISTINCT)
        ec_data = {name: make_ecdsa_dataset(pool, name, args.seed + k,
                                            EC_SIGNERS, EC_MESSAGES)
                   for k, name in enumerate(("secp256k1", "secp256r1"))}
    ec_base = {name: data[0] for name, data in ec_data.items()}
    log(f"dataset: {len(base)} + {B7_DISTINCT} (B7) Ed25519 signed "
        f"messages from {SIGNERS} signers, {EC_MESSAGES} ECDSA ones per "
        f"curve from {EC_SIGNERS} signers in {time.perf_counter() - t0:.1f} "
        "s")
    t0 = time.perf_counter()
    b7_items, b7_want = b7_batch(b7_base, args.seed + 41)
    b7 = (b7_preps(ed, b7_items), b7_want)
    log(f"B7 preps of {B7_DISTINCT} adversarial items "
        f"({b7_want.count(False)} invalid) in {time.perf_counter() - t0:.1f} "
        "s")
    tables = ed.split_tables(dev)
    k1_tables = wc.hybrid_tables(dev)
    r1_tables = wc.r1_split_tables(dev)
    wc.windowed_tables(ecmath.SECP256K1, dev)     # B5's 2^16-row k1 table

    t_phase = log_phase("probe, build and datasets", t_phase)

    # -- phase 2: each kernel against its plain version ---------------------
    per_kernel = {name: {} for name in KERNELS}
    for bucket in BUCKETS:
        if wanted("ed25519_split_verify"):
            items, want = tile(base, bucket, args.seed + bucket)
            *wire, precheck = ed.prepare_batch_split(items)
            dargs = ed.wire_to_device(*wire, device=dev)
            per_kernel["ed25519_split_verify"][bucket] = compare_kernel(
                "ed25519_split_verify", ed.verify_core_split,
                ed.verify_core_split_plain, dargs, tables, bucket,
                NIELS_TABLE_BYTES, lambda k: k & precheck, want, card)

        curve = ecmath.SECP256K1
        items, want = ecdsa_kernel_batch(curve, ec_base["secp256k1"], bucket,
                                         args.seed + 3 * bucket)
        batches = {"secp256k1": (items, want)}
        if wanted("secp256k1_hybrid_verify"):
            *wire, precheck = wc.prepare_batch_hybrid_wide(items)
            rows = np.unique(wire[0] & ((1 << 18) - 1)).size
            per_kernel["secp256k1_hybrid_verify"][bucket] = compare_kernel(
                "secp256k1_hybrid_verify", wc.verify_core_hybrid_wide,
                wc.verify_core_hybrid_wide_plain,
                wc.wire_to_device(wire, dev), k1_tables, bucket,
                rows * G_ROW_BYTES, lambda k: k & precheck, want, card)

        curve = ecmath.SECP256R1
        items, want = ecdsa_kernel_batch(curve, ec_base["secp256r1"], bucket,
                                         args.seed + 5 * bucket)
        batches["secp256r1"] = (items, want)
        if wanted("secp256r1_split_verify"):
            *wire, precheck, forced = wc.prepare_batch_r1_split(curve, items)
            rows = (np.unique(wire[0][:, 0]).size
                    + np.unique(wire[0][:, 1]).size)
            per_kernel["secp256r1_split_verify"][bucket] = compare_kernel(
                "secp256r1_split_verify", wc.verify_core_r1_split,
                wc.verify_core_r1_split_plain,
                wc.wire_to_device(wire, dev), r1_tables, bucket,
                rows * G_ROW_BYTES, lambda k: (k & precheck) | forced, want,
                card)

        # B5 and B8 on the same adversarial buckets as B3 (k1) and B4 (r1)
        for name, meta in KERNELS.items():
            if "mode" not in meta or not wanted(name):
                continue
            curve = _curve(meta["curve"])
            items, want = batches[meta["curve"]]
            (kernel, plain, dargs, tail, tbytes,
             precheck) = mode_kernel_case(wc, curve, meta["mode"], items, dev)
            per_kernel[name][bucket] = compare_kernel(
                name, kernel, plain, dargs, tail, bucket, tbytes,
                lambda k, pre=precheck: k & pre, want, card)

        if bucket == 1024:
            ragged_base = batches
        # B7 on one adversarial batch, prepped once and tiled
        for name in B7_KERNELS:
            if not wanted(name):
                continue
            (kernel, plain, dargs, tail, tbytes, precheck,
             want) = b7_case(ed, name, b7[0][name], b7[1], bucket, dev)
            per_kernel[name][bucket] = compare_kernel(
                name, kernel, plain, dargs, tail, bucket, tbytes,
                lambda k, pre=precheck: k & pre, want, card)
    # the rows' buckets beyond BUCKETS: B7 Shamir's pairs at 16384
    for name, bucket in ROW_BUCKETS.items():
        if wanted(name):
            (kernel, plain, dargs, tail, tbytes, precheck,
             want) = b7_case(ed, name, b7[0][name], b7[1], bucket, dev)
            per_kernel[name][bucket] = compare_kernel(
                name, kernel, plain, dargs, tail, bucket, tbytes,
                lambda k, pre=precheck: k & pre, want, card)
    # B5 and B8 GLV held raw at ragged sizes
    for name in RAGGED_KERNELS:
        if not wanted(name):
            continue
        curve = _curve(KERNELS[name]["curve"])
        for n in RAGGED:
            items, want = ragged_base[curve.name]
            items = [items[j % len(items)] for j in range(n)]
            want = [want[j % len(want)] for j in range(n)]
            (kernel, plain, dargs, tail, _,
             precheck) = mode_kernel_case(wc, curve, KERNELS[name]["mode"],
                                          items, dev)
            hold_kernel(name, kernel, plain, dargs, tail, n,
                        lambda k, pre=precheck: k & pre, want)
        log(json.dumps({"kernel": name, "raw_identical_at": RAGGED,
                        "card": card}))
    # the B7 kernels: both lane variants forced, at the ragged sizes, the
    # lane threshold +-1 and every bucket, and timed in turns at the
    # threshold +-1, 16384 and 32768
    for name in B7_KERNELS:
        if wanted(name):
            hold_b7_lanes(ed, name, b7[0][name], b7[1],
                          RAGGED + B7_THRESHOLD + BUCKETS
                          + (ROW_BUCKETS[name],),
                          B7_THRESHOLD + (ROW_BUCKETS[name], 32768),
                          dev, card)
    log("library_ms: null — no PyTorch call computes Ed25519 or ECDSA "
        "verification")
    if only is not None:
        t_phase = log_phase("kernels", t_phase)
        log(json.dumps({"kernels_checked": sorted(only)}))
        if args.ab is not None:
            ab_phase(args.ab, dev, card, args.seed + 53, ec_base, b7,
                     wanted)
            log_phase("ab", t_phase)
        return 0
    b10_rows = b10_kernel_phase(dev, card, args.seed + 43)
    b6_rows = b6_kernel_phase(dev, card, args.seed + 23)
    log("library_ms: null — no PyTorch call computes SHA-256; "
        "sha256_blocks is held to its plain version and hashlib here but is "
        "not on the Merkle path (the JAX package hashes leaves on the host "
        "too), so it is not in the kernels line")
    t_phase = log_phase("kernels", t_phase)

    # -- phase 3: every verify_batch mode ------------------------------------
    modes, mode_launches = modes_phase(wc, dev, ec_base, args.seed + 31,
                                       card, per_kernel)
    log(json.dumps({"path": "verify_batch_modes", **modes}))
    t_phase = log_phase("modes", t_phase)

    # -- phase 4: the Merkle path --------------------------------------------
    merkle, b6_launches = merkle_phase(dev, card, args.seed + 29)
    log(json.dumps({"path": "merkle", **merkle}))
    t_phase = log_phase("merkle", t_phase)

    # -- phase 5: the sharded path (B9) --------------------------------------
    mesh, b7_launches = mesh_phase(dev, card, args.seed + 47, base, ec_base,
                                   b7)
    log(json.dumps({"path": "mesh", **mesh}))
    t_phase = log_phase("mesh", t_phase)

    # -- phase 6: the SIMM margin (B10) --------------------------------------
    simm_out, b10_launches = simm_phase(dev, card, args.seed + 43)
    log(json.dumps({"path": "simm", **simm_out}))
    t_phase = log_phase("simm", t_phase)

    # -- phase 7: the service paths ------------------------------------------
    from corda_tpu_torch.core.crypto import Crypto, PublicKey
    from corda_tpu_torch.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                                     ECDSA_SECP256R1_SHA256,
                                                     EDDSA_ED25519_SHA512)
    from corda_tpu_torch.observability import (KernelProfiler, get_profiler,
                                               set_profiler)
    from corda_tpu_torch.ops.staging import get_staging_pool
    from corda_tpu_torch.verifier import (SignatureBatcher,
                                          TpuTransactionVerifierService)

    def checks_of(items):
        return [(PublicKey(EDDSA_ED25519_SHA512, p), s, m) for p, s, m in items]

    # Ed25519
    bulk_items, bulk_want = tile(base, 32768, args.seed + 1)
    bulk = checks_of(bulk_items)
    inter_items, inter_want = tile(base, 1024, args.seed + 2)
    inter = checks_of(inter_items)

    batcher = SignatureBatcher(device="cuda")
    # warm-up outside the counted run: first-use table upload and pinned
    # buffer allocation at both shapes
    batcher.submit_group(bulk).result(timeout=600)
    batcher.submit_group(inter, latency_class="interactive").result(timeout=600)
    batcher.close()

    batcher = SignatureBatcher(device="cuda")
    set_profiler(KernelProfiler())
    ed.verify_core_split.launches = 0
    ed.verify_core_split.launches_by_lanes.update({1: 0, 2: 0})
    t0 = time.perf_counter()
    futs = [batcher.submit_group(bulk) for _ in range(BULK_GROUPS)]
    submit_s = time.perf_counter() - t0
    bulk_got = [f.result(timeout=900) for f in futs]
    bulk_s = time.perf_counter() - t0
    bulk_snap = batcher.metrics.snapshot()
    inter_lat, inter_got = [], None
    for _ in range(INTERACTIVE_RUNS):
        t1 = time.perf_counter()
        inter_got = batcher.submit_group(
            inter, latency_class="interactive").result(timeout=600)
        inter_lat.append(time.perf_counter() - t1)
    single_lat, single_got = [], []
    for i in range(SINGLES):
        c = bulk[i]
        t1 = time.perf_counter()
        single_got.append(batcher.submit(*c).result(timeout=120))
        single_lat.append(time.perf_counter() - t1)
    ed_launches = ed.verify_core_split.launches
    ed_by_lanes = dict(ed.verify_core_split.launches_by_lanes)
    breakers = batcher.breaker_status()
    snap = batcher.metrics.snapshot()
    batcher.close()
    ed_overlap = get_profiler().snapshot()["overlap"]["overlap_pct"]

    for got in bulk_got:
        if got != bulk_want:
            raise SystemExit("bulk verdicts disagree with the construction")
    if inter_got != inter_want:
        raise SystemExit("interactive verdicts disagree with the construction")
    if single_got != bulk_want[:SINGLES]:
        raise SystemExit("single-submit verdicts disagree with the construction")
    rng = random.Random(args.seed + 3)
    for i in rng.sample(range(len(bulk)), ORACLE_SAMPLE):
        if Crypto.is_valid(*bulk[i]) != bulk_want[i]:
            raise SystemExit(f"host oracle disagrees on bulk item {i}")
    require_clean(snap, breakers,
                  BULK_GROUPS * len(bulk) + INTERACTIVE_RUNS * len(inter),
                  "ed25519")
    if 0 in ed_by_lanes.values():
        raise SystemExit("the Ed25519 path launched a kernel no time: "
                         f"{ed_by_lanes} by lanes a signature")
    prep = bulk_snap.get("SigBatcher.ed25519.Prep", {})
    dur = bulk_snap.get("SigBatcher.ed25519.Duration", {})
    inter_lat.sort()
    single_lat.sort()
    service = {
        "card": card,
        "service_verifies_per_s": BULK_GROUPS * len(bulk) / bulk_s,
        "bulk_items": BULK_GROUPS * len(bulk), "bulk_wall_s": bulk_s,
        "interactive_1k_p50_ms": 1e3 * statistics.median(inter_lat),
        "interactive_1k_p99_ms": 1e3 * inter_lat[
            min(len(inter_lat) - 1, int(0.99 * len(inter_lat)))],
        "interactive_runs": len(inter_lat),
        "single_submit_p50_ms": 1e3 * statistics.median(single_lat),
        "single_submit_route": "host (below host_crossover=192)",
        "device_batches": count(snap, "SigBatcher.DeviceBatches"),
        "device_checked": count(snap, "SigBatcher.DeviceChecked"),
        "host_routed": count(snap, "SigBatcher.HostRouted"),
        "batch_failures": count(snap, "SigBatcher.BatchFailure"),
        "kernel_launches": ed_launches,
        "kernel_launches_by_lanes": ed_by_lanes,
        "bulk_submit_s": submit_s,
        "bulk_prep_mean_ms": 1e3 * prep.get("mean_s", 0.0),
        "bulk_prep_max_ms": 1e3 * prep.get("max_s", 0.0),
        "bulk_finish_wait_mean_ms": 1e3 * dur.get("mean_s", 0.0),
        "bulk_device_busy_share_est": BULK_GROUPS
        * per_kernel["ed25519_split_verify"][32768]["ms"] / 1e3 / bulk_s,
        "prep_device_overlap_pct": ed_overlap,
        "breakers": {k: v["state"] for k, v in breakers.items()},
        "staging": get_staging_pool().stats(),
    }
    traced_s, busy_s, kernel_s = traced_window(
        lambda: SignatureBatcher(device="cuda"), [bulk] * BULK_GROUPS,
        [bulk_want] * BULK_GROUPS)
    service.update({
        "traced_bulk_wall_s": traced_s,
        "traced_device_busy_s": busy_s,
        "traced_kernel_s": kernel_s,
        "traced_device_idle_share": idle_share(busy_s, traced_s),
    })
    log(json.dumps({"path": "ed25519", **service}))

    # ECDSA: secp256k1 and secp256r1 bulk and interactive groups
    schemes = {"secp256k1": ECDSA_SECP256K1_SHA256,
               "secp256r1": ECDSA_SECP256R1_SHA256}
    ec_bulk, ec_inter = {}, {}
    for k, (name, scheme) in enumerate(schemes.items()):
        curve = _curve(name)

        def tamper_fn(it, kind, other, curve=curve):
            return tamper_ecdsa(curve, it, kind, other)
        items, want = tile(ec_base[name], 32768, args.seed + 11 + k,
                           tamper_fn)
        ec_bulk[name] = ([to_check(curve, scheme, it) for it in items], want,
                         items)
        items, want = tile(ec_base[name], 1024, args.seed + 13 + k,
                           tamper_fn)
        ec_inter[name] = ([to_check(curve, scheme, it) for it in items], want)

    batcher = SignatureBatcher(device="cuda")
    for name in schemes:
        batcher.submit_group(ec_bulk[name][0]).result(timeout=600)
        batcher.submit_group(ec_inter[name][0],
                             latency_class="interactive").result(timeout=600)
    batcher.close()

    batcher = SignatureBatcher(device="cuda")
    set_profiler(KernelProfiler())
    wc.verify_core_hybrid_wide.launches = 0
    wc.verify_core_r1_split.launches = 0
    ec_service = {"card": card}
    bulk_snaps = {}
    for name in schemes:
        checks, want, _ = ec_bulk[name]
        t0 = time.perf_counter()
        futs = [batcher.submit_group(checks) for _ in range(EC_BULK_GROUPS)]
        submit_s = time.perf_counter() - t0
        got = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        if any(g != want for g in got):
            raise SystemExit(f"{name} bulk verdicts disagree with the "
                             "construction")
        bulk_snaps[name] = batcher.metrics.snapshot()
        ec_service[name] = {
            "service_verifies_per_s": EC_BULK_GROUPS * len(checks) / wall,
            "bulk_items": EC_BULK_GROUPS * len(checks), "bulk_wall_s": wall,
            "bulk_submit_s": submit_s}
    k1_bulk_launches = wc.verify_core_hybrid_wide.launches
    for name in schemes:
        checks, want = ec_inter[name]
        lat = []
        for _ in range(EC_INTERACTIVE_RUNS):
            t1 = time.perf_counter()
            got = batcher.submit_group(
                checks, latency_class="interactive").result(timeout=600)
            lat.append(time.perf_counter() - t1)
            if got != want:
                raise SystemExit(f"{name} interactive verdicts disagree "
                                 "with the construction")
        lat.sort()
        ec_service[name].update({
            "interactive_1k_p50_ms": 1e3 * statistics.median(lat),
            "interactive_1k_max_ms": 1e3 * lat[-1],
            "interactive_runs": len(lat)})
    breakers = batcher.breaker_status()
    snap = batcher.metrics.snapshot()
    batcher.close()
    k1_launches = wc.verify_core_hybrid_wide.launches
    r1_launches = wc.verify_core_r1_split.launches
    ec_overlap = get_profiler().snapshot()["overlap"]["overlap_pct"]
    require_clean(snap, breakers, len(schemes) * (
        EC_BULK_GROUPS * 32768 + EC_INTERACTIVE_RUNS * 1024), "ecdsa")
    if k1_launches == 0 or r1_launches == 0:
        raise SystemExit("the ECDSA path launched a kernel no time: "
                         f"k1 {k1_launches}, r1 {r1_launches}")

    # mixed Ed25519/secp256k1/secp256r1 transactions through verify_signed
    # (their ECDSA signatures on the process pool)
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        stxs = mixed_transactions(args.seed + 17, ec_data, pool)
        oracle = {}
        for k, name in enumerate(schemes):
            checks, want, items = ec_bulk[name]
            sample = random.Random(args.seed + 19 + k).sample(
                range(len(items)), ORACLE_SAMPLE)
            got = list(pool.map(_ecdsa_oracle_job,
                                [(name, items[i]) for i in sample],
                                chunksize=8))
            oracle[name] = [want[i] for i in sample] == got
    if not all(oracle.values()):
        raise SystemExit(f"host oracle disagrees with the construction: "
                         f"{oracle}")
    tx_want = [t % 8 != 3 for t in range(MIXED_TXS)]
    svc = TpuTransactionVerifierService(batcher=SignatureBatcher(
        device="cuda", host_crossover=0))
    ed.verify_core_split.launches = 0
    wc.verify_core_hybrid_wide.launches = 0
    wc.verify_core_r1_split.launches = 0
    services = SmokeServices()
    t0 = time.perf_counter()
    futs = [svc.verify_signed(stx, services) for stx in stxs]
    outcomes = []
    for f in futs:
        try:
            f.result(timeout=600)
            outcomes.append(True)
        except Exception as exc:   # the outcome under test
            if type(exc).__name__ != "SignatureException":
                raise
            outcomes.append(False)
    mixed_s = time.perf_counter() - t0
    mixed_breakers = svc.batcher.breaker_status()
    mixed_snap = svc.batcher.metrics.snapshot()
    svc.shutdown()
    mixed_launches = {"ed25519": ed.verify_core_split.launches,
                      "secp256k1": wc.verify_core_hybrid_wide.launches,
                      "secp256r1": wc.verify_core_r1_split.launches}
    if outcomes != tx_want:
        raise SystemExit("verify_signed outcomes disagree with the "
                         "construction")
    require_clean(mixed_snap, mixed_breakers, 3 * MIXED_TXS, "verify_signed")
    if 0 in mixed_launches.values():
        raise SystemExit("the mixed verify_signed path launched a kernel no "
                         f"time: {mixed_launches}")
    for name in schemes:
        bs = bulk_snaps[name]
        ec_service[name].update({
            "bulk_prep_mean_ms": 1e3 * bs.get(f"SigBatcher.{name}.Prep",
                                              {}).get("mean_s", 0.0),
            "bulk_finish_wait_mean_ms": 1e3 * bs.get(
                f"SigBatcher.{name}.Duration", {}).get("mean_s", 0.0),
            "oracle_sample_agrees": oracle[name]})
    ec_service.update({
        "device_checked": count(snap, "SigBatcher.DeviceChecked"),
        "batch_failures": count(snap, "SigBatcher.BatchFailure"),
        "host_routed": count(snap, "SigBatcher.HostRouted"),
        "prep_device_overlap_pct": ec_overlap,
        "breakers": {k: v["state"] for k, v in breakers.items()},
        "hybrid_k1_launches": k1_launches,
        "hybrid_k1_bulk_launches": k1_bulk_launches,
        "r1_split_launches": r1_launches,
        "r1_split_stats": wc.r1_split_stats(),
        "mixed_txs": MIXED_TXS, "mixed_tx_type": type(stxs[0]).__name__,
        "mixed_wall_s": mixed_s,
        "mixed_tx_per_s": MIXED_TXS / mixed_s,
        "mixed_device_checked": count(mixed_snap,
                                      "SigBatcher.DeviceChecked"),
        "mixed_device_batches": count(mixed_snap,
                                      "SigBatcher.DeviceBatches"),
        "mixed_kernel_launches": mixed_launches,
    })
    groups, want = [], []
    for name in schemes:
        checks, w, _ = ec_bulk[name]
        groups += [checks, checks]
        want += [w, w]
    traced_s, busy_s, kernel_s = traced_window(
        lambda: SignatureBatcher(device="cuda"), groups, want)
    ec_service.update({
        "traced_bulk_groups": len(groups), "traced_bulk_wall_s": traced_s,
        "traced_device_busy_s": busy_s, "traced_kernel_s": kernel_s,
        "traced_device_idle_share": idle_share(busy_s, traced_s)})
    log(json.dumps({"path": "ecdsa", **ec_service}))
    t_phase = log_phase("service", t_phase)

    # -- phase 7b: the out-of-process verifier --------------------------------
    oop = oop_phase(card, stxs, tx_want, base, bulk, bulk_want,
                    ec_service["mixed_tx_per_s"],
                    service["service_verifies_per_s"])
    log(json.dumps({"path": "oop", **oop}))
    t_phase = log_phase("oop", t_phase)

    # -- phase 8: an earlier commit's B3, B5, B7 and B8 ----------------------
    if args.ab is not None:
        ab_phase(args.ab, dev, card, args.seed + 53, ec_base, b7)
        log_phase("ab", t_phase)


    # B3's 32768 row counts the service path's bulk launches, its 1024 row
    # the interactive ones; B5's and B8's rows the modes phase's 32768 and
    # MODE_SMALL runs; the B7 kernels' rows the mesh phase's one-lane
    # (32768-item shard) and lane-pair (16384-item shards) launches
    launches = {"ed25519_split_verify": ed_by_lanes[1],
                "ed25519_split_verify_pairs": ed_by_lanes[2],
                "secp256k1_hybrid_verify": k1_bulk_launches,
                "secp256k1_hybrid_verify_1024": k1_launches - k1_bulk_launches,
                "secp256r1_split_verify": r1_launches, **b6_launches,
                **mode_launches, **b7_launches}
    rows = []
    for name, (lib_name, bucket) in [*((n, (n, 32768)) for n in KERNELS),
                                     *PAIR_ROWS.items()]:
        meta = KERNELS[lib_name]
        top = per_kernel[lib_name][bucket]
        if launches[name] == 0:
            raise SystemExit(f"{name} (lanes {top['lanes']}) was launched no "
                             "time on its path")
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(b["max_abs_err"]
                               for b in per_kernel[lib_name].values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "bucket": bucket, "lanes": top["lanes"]})
    for name, meta in B6_KERNELS.items():
        fn = meta["row"][0]
        top = b6_rows[meta["row"]]
        rows.append({
            "name": name, "route": "cuda",
            "source": "corda_tpu_torch/csrc/sha256.cu",
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for (f, _), r in
                               b6_rows.items() if f == fn),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None})
    top = b10_rows[SIMM_SIZES[-1]]
    rows.append({
        "name": B10["name"], "route": "cuda", "source": B10["source"],
        "replaces": B10["replaces"], "launches": b10_launches,
        "max_abs_err": max(r["max_abs_err"] for r in b10_rows.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"]})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
