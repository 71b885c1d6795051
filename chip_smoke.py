"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card's name and power limit (nvidia-smi), its top SM
     clock, torch, CUDA and nvcc versions; stops unless torch sees a CUDA
     device;
  2. build: compiles the native host library (native.py: g++ on
     host/recode.cpp), then msm_blst_tpu_torch/csrc/*.cu (one nvcc per
     source, in parallel) and reports the times, each nvcc's, and each
     kernel's
     registers and spills; K3's, K4's and K5's kernels must keep
     FOLD_WAVE // 132 blocks resident an SM
     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the wave the host
     schedules their launches for, K2's wide kernels
     the blocks their launch bounds ask for (kernels.point_min_blocks()),
     and K6's stage kernels the blocks its persistent grid is sized for
     (kernels.sos_min_blocks());
  3. drivers: the three measurement drivers of the port (microbench,
     mxu_experiment, gather_bench) at the JAX drivers' shapes, each
     printing its JSON lines and counting its launches on its own; the
     microbench's K7 and int8 matmul rates are the measured anchors beside
     the published peaks in every bound below;
  4. kernels: each CUDA kernel, G1 and G2 instances, K6 at every stage, K7
     for each dtype and K8, against its plain PyTorch version on the card at
     the shapes of the n=2^16 paths and the drivers (K1 and K6 at 2^20 and
     at the plan build's batch-inversion columns of 10,752, there also
     under a CUDA graph), exact equality, with
     CUDA-event times of both, of the library call where one computes the
     same function, and the least time the card could take for the same
     work (bytes, integer multiply-adds, tensor-core MACs or FMAs); K3 (the
     prefix level) at the level shapes of the CHES, BGMW and stock paths
     and at the JAX package's CHES shape (112, 8,192), K9 (the segmented
     fold) on the CHES integration's six gap groups and K4 (the block scan)
     at the stream lengths of the query paths (109,243, 32,768, 16,384, 64)
     and at 8,192 and 2,048, each with the depth of its longest chain of
     adds beside one add's time on fp.cuh's product (the one K3, K4 and K9
     run; K2's runs on carry chains); K2's two launches of the CHES query
     on their real inputs: the bucket boundaries of a CONFIGS[16] recode
     (109,244 buckets) and the Horner combine of the six gap groups K9
     folded; K5 (the segmented reduction) at a stock window's and BGMW's
     shapes (cuda_scan.seg_level_shape): its affine level on real table
     rows, then its segmented scan over that level's heads and tails, the
     bucket arrays included, a doubling and a cancellation meeting in the
     scan; K8 and torch.take also under a
     CUDA graph of 20 calls (the kernels without the host's launch work), beside
     K8's cluster size and the clusters of it the card keeps resident;
  5. main path: the G1 CHES n=2^16 query (params.CONFIGS[16]) — fixed
     points, the plan, one warm-up and five timed scalar sets — with every
     result checked against the pure-Python oracle and every kernel of the
     path launched, K3 at the level shape prefix_pipeline.stream_shape
     gives the path's stream; then the same under the SOS multiply
     (mul_impl="sos", plan build included), which must launch K6 and never
     K1; each path prints K1's and K6's launches by batch size;
  6. algorithms: one G1 plan with the CHES, BGMW95 and stock tables at the
     same n and config; host-recode CHES, BGMW95 and stock Pippenger, BGMW
     and stock with both bucket strategies (prefix, segmented), each query
     checked against the oracle; the plan build and each path count their
     launches on their own: every kernel of the path (K5's level and scan
     on the segmented ones, K9 on all) launched, none of the other
     strategy's, K3 (prefix paths) at stream_shape's level shapes and K5's
     level (segmented paths) at seg_level_shape's, K5's level and scan once
     a bucket pass; each query path prints its K2 dadd, K9, K4 and K5
     launches a query, and those of K2's boundary and Horner launches; a
     CHES path launches each of these once a query and no K2 dadd or
     double of its own;
  7. g2: phases 5 and 6 over G2 at the same n and config (the SOS query
     on two scalar sets), each path launching the G2 kernels (and K1 or
     K6, which Fp2's products run through) and none of the G1 point and
     level kernels;
  8. harness: the reference's harness on the port: drivers/run_msm.py
     (run_msm.main) over its five methods at CONFIGS[16], G1 on two
     scalar sets (its plan cached to a temporary directory and loaded
     back for the noindexhash query under the segmented strategy, which
     must launch K5's level and scan) and G2 on one, every method equal
     to the others and to the oracle, each method's launches a path of
     its own (G1_run_msm_ches_noindexhash, ...; the noindexhash path
     launching the kernels of the index-keyed CHES path); the stage
     profilers profile_stages at 2^16 and bign_profile at 2^19 (CHES and
     BGMW95), each printing its JSON line; entry()'s query on the card
     against the oracle; curves/mult.py (point_mult, ladder_mult,
     msm_wbits, points_add, in_group_device) on G1 at 256 lanes and G2 at
     64, the scalars 0, 1 and r - 1 and the point at infinity among them
     (G1: a point outside the subgroup too), against the oracle, each
     path with its K1 and K2 launches by batch size;
  9. protocol: batched hash to curve (protocol/device_map.py): the edge
     lanes first (map_to_g1_device, cleared and not, on u = 0, 1, p - 1
     and u whose g(x1) is and is not a square; hash_to_g1_device's body on
     u pairs whose maps double, cancel, and u0 = u1 = 0 in K2's add; the
     Fp2 square root on -1, -25, 0 and a non-residue), then
     hash_to_g1_device over 4,096 seeded messages (8,192 SSWU lanes) and
     map_to_g2_device over 2,048 seeded u values (u = 0, c0 = 0 and u in
     Fp first), each one warm-up and two timed batches with their wall
     and device ms and us a message, every lane against the port's host
     oracle (hash_to_g1, map_to_curve_g2) and every G1 point in the group
     (in_group_device); each path (G1_hash_to_g1, G2_map_to_g2) launching
     K1 (and on G1 K2's doubling and mixed add) and no other kernel, with
     K1's launches by batch size;
 10. facade: the blst-named API (api.py) at n = 2^16 (CONFIGS[16]) on
     the reference's points: on G1 and G2 the CHES first call (split into
     digest, point conversion, plan build and query), three repeat calls
     against as many engine.msm_ches_device queries on the memo's plan
     (the same kernels and counts; both timed, with the host's share:
     digest, scalar conversion, result to ints), the BGMW95 call that
     upgrades the plan in place (the 3nh table's object kept) and a CHES
     call after it; on G1 the stale-plan case (a point the JAX digest's
     probes skip replaced in the same list object, the next call against
     the new oracle), the native scalar conversion beside its numpy twin
     (the same words), p1s_add and p1s_to_affine with infinity lanes and
     wbits at w = 5 over 2^12 points; stock and the tile at window 13 on
     both curves; one G1 CHES call at n = 100,000 (the nearest shipped
     radix); every result against the oracle, each call group a path of
     its own; the plan memo cleared after;
 11. bign: streamed plans (the window-major "j" layout) at n = 2^21
     (params.CONFIGS[21], the BGMW table aliased into the 3nh one) on G1
     and G2, with their build times and peak device memory; on G1
     msm_ches_device and msm_bign (CHES and BGMW95) at the chunk count the
     free memory gives and at BIGN_CHUNKS, and msm_ches_device with
     noindexhash=True (2,097,154 value buckets); on G2 msm_bign CHES and
     BGMW;
     then CONFIGS[20]'s BGMW-only plan (its own nh table) on G1 and its
     msm_bign; each query after a warm-up on BIGN_SEEDS (G2 and 2^20:
     G2_BIGN_SEEDS), against the oracle, with its mean and min ms, peak
     memory, chunks a query and every K3 launch at stream_shape of its
     chunk; K3 at the 2^21 level shape (its first and last 128 lanes held
     step by step to the plain mixed add), K4 over its tails and (G1) the
     874,436 CHES suffix sums, K1 at the 2^21 window inversions' commonest
     batch and at a window's 3n lanes, each against its plain version;
     the 2^16 plan through the cache (save_plan, load_plan) and two
     queries from the loaded plan;
 12. sharded: the sharded paths (parallel/sharded.py) on 4 spawned ranks
     over a FileStore in a temporary directory (parallel.run_ranks: on
     one card all four share it in a gloo group; a rank that fails or
     hangs past the timeout fails the run): K2 dadd first at the butterfly's widths
     (109,244 lanes, G1 also 874,437; G2 109,244) against its plain
     version; then at CONFIGS[16] G1's points-axis CHES and BGMW (the
     r - a fold), the 2 x 2 mesh's CHES, the window-sharded "j" CHES (h =
     14 padded to 16) and BGMW (its own nh table, h' = 15 padded to 16),
     G2's points-axis CHES, and at CONFIGS[21] G1's window-sharded CHES
     and aliased BGMW on one rank-local plan of 3 windows a rank; each
     plan built by one rank after another and sharded (its block copied,
     the full plan dropped); on every rank, each path's warm-up and
     counted query against the oracle, with 0, 1, r - 1, an equal pair,
     r, r + 5 and 2^255 - 1 among the scalars; each stage's launches (the
     all-reduce K2 dadd once a round and nothing else), the stages timed
     (local accumulation, the all-reduce's exchanges and K2 dadds, the
     integration), the rows held, the peak memory; then the edge cases: a
     3-rank subgroup refused ("power of two"), a one-rank NCCL group's
     query against msm_ches_device, a "j" plan refused by the points-axis
     functions; each path's launches summed over the ranks;
 13. a JSON line of per-kernel results (the new shapes under
     "at_<shape>"), then the final status line.

It catches no exception: any failure exits non-zero before the last line.
"""

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_LOG = 16
WARM_SEED = 1
SEEDS = (2, 3, 4, 5, 6)
ALGO_SEEDS = (7, 8, 9)  # timed scalar sets of phase 6 (stock: the first two)
G2_ALGO_SEEDS = (7, 8)  # and of its G2 run (stock: the first one)
G2_SOS_SEEDS = (2, 3)  # timed scalar sets of the G2 query under SOS

# The least time the card could take (the bound): the largest of the bytes a
# kernel must move over the memory rate and its operations over the rate of
# the unit that runs them. H100 SXM: 3.35 TB/s; 132 SMs, each 64 32-bit
# integer multiply-adds and 128 float32 FMAs per clock at the top SM clock
# nvidia-smi reports; 1,979 TOP/s of int8 on the tensor cores (989.5e12
# MACs). Where the microbench measured a higher rate on this card, the
# bound takes that one: a bound must not exceed what the card can do.
HBM_BYTES_PER_S = 3.35e12
SMS, IMAD_PER_CLOCK, FFMA_PER_CLOCK = 132, 64, 128
INT8_MAC_PER_S = 1979e12 / 2
MEASURED = {}  # "imad", "ffma", "int8_mac": rates the microbench measured
# A 12-word CIOS Montgomery product (csrc/fp.cuh mont_mul): 288 word
# products with 64-bit results (two multiply-adds each) and 12 low halves.
IMAD_PER_MONT = 2 * 288 + 12
# Field multiplies of the point formulas (csrc/fp.cuh, curves/ops.py), as
# (general products, squares), without their doubling branch (taken by the
# few lanes that add a point to itself).
DADD_AFFINE, DADD, DOUBLE = (8, 2), (12, 2), (6, 3)
FP_BYTES = 48


class CurveCase:
    """What the kernel checks and the paths need of one curve: the curve,
    its K2-K5 (kernels.CURVE_KERNELS, by op), bytes per field element and
    the Montgomery products a field product and a square need at least."""

    def __init__(self, name: str):
        from msm_blst_tpu_torch import curves, kernels

        self.curve = getattr(curves, name)
        self.kernels = kernels.CURVE_KERNELS[name]
        self.elem_bytes = 4 * self.curve.F.n_words
        # Fp (F.lead (12,)): one each; Fp2 (F.lead (2, 12)): Karatsuba's
        # three for a product, (a0 + a1)(a0 - a1) and a0 a1 for a square
        self.per_mul, self.per_sqr = ((1, 1) if len(self.curve.F.lead) == 1
                                      else (3, 2))

    def name(self, op: str) -> str:
        """The name the JSON line gives this curve's kernel `op`."""
        return self.kernels[op].name

    def mont(self, formula) -> int:
        """Montgomery products of one formula, (products, squares)."""
        return self.per_mul * formula[0] + self.per_sqr * formula[1]


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


@functools.lru_cache(maxsize=None)
def top_sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def peak_rates() -> dict:
    """Operations a second by unit: the published peak, or the measured
    rate where it is higher."""
    clock = top_sm_mhz() * 1e6
    peak = {"imad": SMS * IMAD_PER_CLOCK * clock,
            "ffma": SMS * FFMA_PER_CLOCK * clock, "int8_mac": INT8_MAC_PER_S}
    return {k: max(v, MEASURED.get(k, 0.0)) for k, v in peak.items()}


def bound(n_bytes: float, n_mont: float = 0, imad: float = 0,
          ffma: float = 0, int8_mac: float = 0) -> dict:
    """The largest of the least times, in ms, and which one it is: bytes
    over the memory rate, and each unit's operations (n_mont Montgomery
    products count IMAD_PER_MONT IMADs each) over its rate."""
    rates = peak_rates()
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max((imad + n_mont * IMAD_PER_MONT) / rates["imad"],
                ffma / rates["ffma"], int8_mac / rates["int8_mac"]) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    print(card_line())
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(f"top SM clock: {top_sm_mhz():g} MHz")
    from msm_blst_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")


def phase_build():
    from msm_blst_tpu_torch import kernels, native

    t0 = time.perf_counter()
    native.load()
    print(f"build: native host library {time.perf_counter() - t0:.3f} s "
          f"({native.library_path().name})")
    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({kernels.library_path().name})")
    print("nvcc: " + ", ".join(f"{src} {sec:.1f} s" for src, sec in
                               sorted(kernels.nvcc_seconds().items())))
    for name, regs in sorted(kernels.ptxas_summary().items()):
        print(f"ptxas {name}: {regs}")
    check_occupancy()


def check_occupancy():
    """K3's, K4's and K5's kernels must keep the resident blocks an SM that
    the host's wave (msm/scan.py FOLD_WAVE blocks on 132 SMs) counts on,
    K2's wide kernels the blocks their launch bounds ask for, and K6's four
    stage kernels the blocks its persistent grid is sized for."""
    from msm_blst_tpu_torch import kernels
    from msm_blst_tpu_torch.msm import scan

    for curve in kernels.CURVE_KERNELS:
        for op in kernels.OCCUPANCY:
            per_sm, why = ((kernels.point_min_blocks(), "the launch bounds ask")
                           if op.startswith("point") else
                           (scan.FOLD_WAVE // SMS, "the wave needs"))
            blocks = kernels.occupancy(curve, op)
            print(f"occupancy {kernels.CURVE_KERNELS[curve][op].name}: "
                  f"{blocks} resident blocks an SM ({why} {per_sm})")
            if min(blocks) < per_sm:
                raise AssertionError(f"{curve} {op}: {blocks} blocks an SM, "
                                     f"below {per_sm}")
    blocks, per_sm = kernels.sos_occupancy(), kernels.sos_min_blocks()
    print(f"occupancy sos_mul (prod, bytes, mm1, full): {blocks} resident "
          f"blocks an SM (the persistent grid is sized for {per_sm})")
    if min(blocks) < per_sm:
        raise AssertionError(f"K6: {blocks} blocks an SM, below {per_sm}")


def _random_fp(n: int, seed: int, dev) -> torch.Tensor:
    """n canonical Fp word vectors (top word below p's), with 0, 1 and p-1
    in the first three lanes."""
    from msm_blst_tpu_torch.constants import P
    from msm_blst_tpu_torch.fields.limb import ints_to_array

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=(12, n), dtype=np.uint64)
    w[11] %= P >> 352
    w[:, :3] = ints_to_array([0, 1, P - 1], 12).view(np.uint32)
    return torch.as_tensor(w.astype(np.uint32).view(np.int32), device=dev)


RESULTS = {}  # kernel name -> its measurements (record)


def record(name, kernel_fn, plain_fn, reps, plain_reps, n_bytes,
           n_mont=0, library_fn=None, graph=False, **ops):
    """The kernel's call against its plain version's on the same inputs
    (exact equality), both timed (device_ms), beside the bound, into
    RESULTS[name]. `graph`: also time the kernel under a CUDA graph of 20
    calls, where the host's launch work is the slower (graph_ms)."""
    from msm_blst_tpu_torch.utils.profiling import device_ms, graph_ms

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(got, want)
    ms = device_ms(kernel_fn, reps)
    plain_ms = device_ms(plain_fn, plain_reps)
    library_ms = None if library_fn is None else device_ms(library_fn, reps)
    b = bound(n_bytes, n_mont, **ops)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms{lib}, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    if err != 0:
        raise AssertionError(f"{name}: kernel and plain version differ")
    RESULTS[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **b, "library_ms": library_ms}
    if graph:
        RESULTS[name]["graph_ms"] = graph_ms(kernel_fn)
        print(f"kernel {name}: graph {RESULTS[name]['graph_ms']:.5f} ms a "
              "call (CUDA graph of 20 calls)")
    return RESULTS[name]


def phase_kernels(dev):
    """Every kernel against its plain version: K1 and K6's stages, K2-K5 for
    G1 and for G2 at the shapes of their n = 2^16 paths, then K7 and K8 at
    the drivers' shapes."""
    from msm_blst_tpu_torch.fields import cuda_mont
    from msm_blst_tpu_torch.fields.limb import FP

    # K1 and K6 on 2^20 elements, then at the batch inversion's column
    # shape, where the host's launch work is the slower: there also under
    # a CUDA graph
    for n, tag in ((1 << 20, ""), (COLUMN, f" {COLUMN}")):
        a = _random_fp(n, 11, dev)
        b = _random_fp(n, 12, dev).flip(1).contiguous()
        reps = 20 if n > COLUMN else 200
        record("mont_mul" + tag, lambda: cuda_mont.mont_mul(a, b, FP),
               lambda: cuda_mont.mont_mul_plain(a, b, FP), reps, 2,
               3 * FP_BYTES * n, n, graph=bool(tag))
        sos_kernels(dev, a, b, functools.partial(record, graph=bool(tag)),
                    tag, reps)
        del a, b
    for name in ("G1", "G2"):
        curve_kernels(dev, CurveCase(name), record)
    driver_kernels(dev, record)
    return RESULTS


# K6's work an element by stage: the full product's IMADs (144 word
# products, two each) and the mmas' u8 MACs without the k padding (T's 48
# bytes against the 48 rows of m, then m's 48 against the 96 rows of m*p)
SOS_IMAD = 2 * 144
SOS_MACS = {"prod": 0, "bytes": 0, "mm1": 48 * 48, "full": 48 * 48 + 96 * 48}


# The batch inversion's column shape: a CONFIGS[16] CHES table's 2,752,512
# elements in utils/scans.pick_chunk's 256 columns, the commonest K1 and K6
# launch of the plan builds
COLUMN = 10752


def sos_name(stage: str) -> str:
    return "sos_mul" if stage == "full" else f"sos_mul_{stage}"


def sos_kernels(dev, a, b, record, tag="", reps=20):
    """K6 at every stage against its plain version on K1's inputs; the full
    stage equals K1 too. `tag` suffixes the names recorded."""
    from msm_blst_tpu_torch.fields import cuda_mont, sos
    from msm_blst_tpu_torch.fields.limb import FP

    B = a.shape[1]
    if not torch.equal(sos.sos_mul(a, b, FP), cuda_mont.mont_mul(a, b, FP)):
        raise AssertionError(f"sos_mul differs from mont_mul at {B}")
    for stage in sos.STAGES:
        record(sos_name(stage) + tag, lambda: sos.sos_stage(a, b, FP, stage),
               lambda: sos.sos_stage_plain(a, b, FP, stage), reps, 2,
               3 * FP_BYTES * B,
               imad=SOS_IMAD * B, int8_mac=SOS_MACS[stage] * B)


# K7's checked and timed chain in chip_smoke: the drivers' (256, 1024)
# elements, CHECK_STEPS steps of 16 multiply-adds (the microbench runs the
# full 32768 steps)
CHECK_STEPS = 512


def driver_kernels(dev, record):
    """K7 for each dtype at the microbench's shape on a shorter chain, and
    K8 on the gather bench's table and indices, torch.take its library
    call."""
    from msm_blst_tpu_torch.drivers import gather_bench, microbench

    for dtype in microbench.DTYPES:
        a, b = microbench.madd_chain_inputs(dtype, device=dev)
        n_madd = microbench.CHAIN * CHECK_STEPS * a.numel()
        unit = {"ffma" if dtype == "float32" else "imad": n_madd}
        record(f"madd_chain_{dtype}",
               lambda: microbench.madd_chain(a, b, CHECK_STEPS, dtype),
               lambda: microbench.madd_chain_plain(a, b, CHECK_STEPS, dtype),
               5, 1, 3 * 4 * a.numel(), **unit)
    d = gather_bench.inputs(device=dev)
    T, N = d["table"].numel(), d["idx"].numel()
    record("gather_smem", lambda: gather_bench.gather_smem(d["table"], d["idx"]),
           lambda: gather_bench.gather_plain(d["table"], d["idx"]), 20, 5,
           4 * (T + 2 * N),
           library_fn=lambda: torch.take(d["table"], d["idx64"]))
    gather_timers(d)


def gather_timers(d):
    """K8 beside torch.take on the gather bench's data under both timers:
    `device_ms` (the kernel table's; the host's launch work counts where it is
    the slower) and `graph_ms` (a CUDA graph of 20 calls: the kernels
    alone), with K8's cluster size and the clusters of it the card keeps
    resident (cudaOccupancyMaxActiveClusters). Fails if the card cannot
    launch K8 at its cluster size or K8 differs from torch.take."""
    from msm_blst_tpu_torch.drivers import gather_bench
    from msm_blst_tpu_torch.utils.profiling import device_ms, graph_ms

    table, idx, idx64 = d["table"], d["idx"], d["idx64"]
    cluster = gather_bench.CLUSTER
    resident = gather_bench.cluster_capacity(table.numel())
    if resident < 1:
        raise AssertionError(f"gather_smem: the card holds no cluster of "
                             f"{cluster} CTAs")
    fns = {"gather_smem": lambda: gather_bench.gather_smem(table, idx),
           "torch.take": lambda: torch.take(table, idx64)}
    if not torch.equal(fns["gather_smem"](), fns["torch.take"]()):
        raise AssertionError("gather_smem differs from torch.take")
    times = {name: (device_ms(fn, 20), graph_ms(fn)) for name, fn in fns.items()}
    print(f"kernel gather_smem timers: cluster {cluster}, {resident} clusters "
          "resident; " + "; ".join(
              f"{name} device_ms {dm:.5f} ms, graph {gm:.5f} ms"
              for name, (dm, gm) in times.items()))


def curve_kernels(dev, case, record):
    """K2 at 2^16 lanes, K3 at the paths' level shapes, K4 and K9 over K3's
    local prefixes at the CHES level (the query paths' stream lengths; the
    CHES integration's gap groups) and K5 at the segmented paths' shapes,
    for one curve."""
    from msm_blst_tpu_torch.curves import cuda_point
    from msm_blst_tpu_torch.msm import fixed_point_list

    curve, E = case.curve, case.elem_bytes
    W = curve.F.n_words

    # K2 on 2^16 lanes
    B = 1 << 16
    pts = fixed_point_list(curve, B, device=dev)
    acc, other, signs = k2_lanes(curve, pts)
    record(case.name("point_dadd_affine"),
           lambda: tuple(cuda_point.xyzz_dadd_affine(curve, acc, pts, signs)),
           lambda: tuple(cuda_point.xyzz_dadd_affine_plain(curve, acc, pts,
                                                           signs)),
           20, 2, (10 * E + 4) * B, case.mont(DADD_AFFINE) * B)
    record(case.name("point_dadd"),
           lambda: tuple(cuda_point.xyzz_dadd(curve, acc, other)),
           lambda: tuple(cuda_point.xyzz_dadd_plain(curve, acc, other)), 20, 2,
           12 * E * B, case.mont(DADD) * B)
    record(case.name("point_double"),
           lambda: tuple(cuda_point.xyzz_double(curve, acc)),
           lambda: tuple(cuda_point.xyzz_double_plain(curve, acc)), 20, 2,
           8 * E * B, case.mont(DOUBLE) * B)

    # K3 at the paths' level shapes, the main path's last
    local = level_kernel(dev, case, record, pts)

    # K4 at the query paths' stream lengths, over K3's local prefixes
    local = local.reshape(-1, 4, W)
    scan_kernel(dev, case, record, local[:109243])

    # K9 on the integration's gap groups, over K3's local prefixes, then
    # K2's Horner combine of the six groups it folded
    folded = fold_kernel(dev, case, record, local[:109243])
    horner_kernel(dev, case, record, folded)

    # K2's bucket boundaries on a CONFIGS[16] recode's level
    boundary_kernel(dev, case, record, pts)

    # K5 at the segmented paths' shapes: a stock window's, then BGMW's
    phase_seg_kernels(dev, case, record, curve.to_rows32(pts).XY,
                      np.random.default_rng(13))


def k2_lanes(curve, pts):
    """K2's inputs on the lanes of the affine points `pts`: xyzz sums `acc`
    (lane 0 infinity, lanes 1 and 2 the point itself, the others its
    double), `other` the points negated where `signs` (every third lane
    from 2), so lane 1 adds P + P and lane 2 P - P."""
    B = pts.X.shape[-1]
    lane = torch.arange(B, device=pts.X.device)
    base = curve.xyzz_from_affine(pts)
    acc = curve.xyzz_double(base)
    acc = curve.select(lane == 0, curve.xyzz_inf((B,), lane.device), acc)
    acc = curve.select((lane == 1) | (lane == 2), base, acc)
    signs = (lane % 3 == 2)
    return acc, curve.xyzz_from_affine(pts, negate=signs), signs


def level_shapes():
    """K3's (c, n_ch) at n = 2^16 (CONFIGS[16]), by path, as the port's
    prefix pipeline shapes them, and the JAX package's CHES shape, first."""
    from msm_blst_tpu_torch.msm import params, prefix_pipeline

    cfg = params.CONFIGS[N_LOG]
    n = 1 << N_LOG
    return {"jax_ches": (112, 8192),
            "stock": prefix_pipeline.stream_shape(n),
            "bgmw": prefix_pipeline.stream_shape(n * cfg.h_bgmw),
            "ches": prefix_pipeline.stream_shape(n * cfg.h)}


def level_kernel(dev, case, record, pts):
    """K3 against its plain version at each of level_shapes(), on rows of
    the 2^16 fixed points `pts` drawn with a seed: lane 0 runs P, 2P, P,
    infinity. The bound counts the level's (c - 1) n_ch mixed adds; the
    print line gives the depth model: c adds times one mixed add (K3's
    own, one_lane_madd_ms), beside K4's depth over the n_ch tails. The JSON
    line keeps the CHES shape's measurements (recorded last) and every
    shape's under "shapes". Returns the CHES level's local rows."""
    from msm_blst_tpu_torch.msm import cuda_scan, scan

    curve, E = case.curve, case.elem_bytes
    W = curve.F.n_words
    name = case.name("affine_prefix_level")
    rows = curve.to_rows32(pts).XY
    one_ms = one_lane_madd_ms(curve, rows)
    shapes = []
    for path, (c, n_ch) in level_shapes().items():
        rng = np.random.default_rng(13)
        slots = torch.as_tensor(rng.integers(0, rows.shape[0], size=c * n_ch),
                                device=dev)
        slots[torch.arange(4, device=dev) * n_ch] = 7  # lane 0: P, 2P, P, inf
        g = rows.index_select(0, slots)
        rx = g[:, :W].reshape(c, n_ch, W).contiguous()
        ry = g[:, W:].reshape(c, n_ch, W).contiguous()
        del g
        sg = torch.as_tensor(rng.integers(0, 2, size=(c, n_ch)), device=dev)
        sg[:2, 0] = 0
        sg[2:4, 0] = 1

        def k3():
            local, t = cuda_scan.affine_prefix_level(curve, rx, ry, sg)
            return (local,) + tuple(t)

        def k3_plain():
            local, t = cuda_scan.affine_prefix_level_plain(curve, rx, ry, sg)
            return (local,) + tuple(t)

        local = k3()[0]
        if bool(local[3, 0, 2 * W:].any()):
            raise AssertionError("K3: P + P - P - P is not infinity")
        r = record(name, k3, k3_plain, 5, 1,
                   c * n_ch * (6 * E + 4) + 4 * E * n_ch,
                   case.mont(DADD_AFFINE) * (c - 1) * n_ch)
        r.update(path=path, c=c, n_ch=n_ch)
        s = scan.scan_schedule(n_ch)
        tails = scan.scan_depth(s)
        print(f"kernel {name} {path} (c, n_ch)=({c}, {n_ch}): "
              f"{-(-n_ch // 128)} blocks, depth {c} adds x one mixed add "
              f"(K3's) {one_ms:.4f} ms = {c * one_ms:.4f} ms; K4 over "
              f"the {n_ch} tails {tuple(s)}, {tails} adds: level and tails "
              f"{c + tails} adds")
        shapes.append(dict(r))
    r["shapes"] = shapes  # r is the kernel's entry in the JSON line
    return local


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds a call of `fn` takes, back to back, when the
    host is not the limit: a spin kernel holds the stream for 0.2 s while
    the host enqueues the `reps` calls, so the events time the card alone
    (a one-lane launch takes the host longer to issue than the card to
    run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(top_sm_mhz() * 1e6 * 0.2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The unit of the depth figures of K3, K4 and K9, which run fp.cuh's
# portable product (K2's runs on carry chains, csrc/k2_mul.cuh): one add's
# latency in one of them. K4 on two elements is one tile whose longest
# chain is scan_depth(scan_schedule(2)) = 8 adds; K3 on a lane of two
# columns is one mixed add.
def one_lane_dadd_ms(curve, pts) -> float:
    """queued_ms of K4 on lanes 0 and 4 of `pts`, over its depth: one xyzz
    add's latency on fp.cuh's product."""
    from msm_blst_tpu_torch.curves import XyzzPoint
    from msm_blst_tpu_torch.msm import scan

    two = XyzzPoint(*(torch.cat([c[..., :1], c[..., 4:5]], dim=-1)
                      for c in pts))
    depth = scan.scan_depth(scan.scan_schedule(2))
    return queued_ms(lambda: scan.prefix_scan_xyzz(curve, two), 50) / depth


def one_lane_madd_ms(curve, rows) -> float:
    """queued_ms of K3 on one lane of two columns (rows 0 and 4 of the
    table `rows`): one mixed add's latency on fp.cuh's product."""
    from msm_blst_tpu_torch.msm import cuda_scan

    W = curve.F.n_words
    g = rows[torch.tensor([0, 4], device=rows.device)]
    rx = g[:, :W].reshape(2, 1, W).contiguous()
    ry = g[:, W:].reshape(2, 1, W).contiguous()
    sg = torch.zeros((2, 1), dtype=torch.int32, device=rows.device)
    return queued_ms(lambda: cuda_scan.affine_prefix_level(curve, rx, ry, sg),
                     50)


# K4's stream lengths on the query paths at n = 2^16: stock's weighted sums
# of its bucket grid's rows, the K3 level's lane tails (stock's windows:
# 16,384; CHES and BGMW: 32,768), and the CHES integration's suffix scan
# (|B| - 1), recorded last; 2,048 and 8,192 were the tails of the level's
# earlier shape (the JAX package's)
SCAN_LENGTHS = (64, 2048, 8192, 16384, 32768, 109243)


def scan_kernel(dev, case, record, rows):
    """K4 against its plain twin at each of SCAN_LENGTHS: the first N of a
    109,243-point xyzz batch (`rows`: (M, 4, W) words of real sums) that
    starts P, P, -2P (the running sum doubles, then cancels), holds a P, -P
    pair at 10, 11 and infinity every 997th lane from 5. Beside the bound,
    which counts the function's N - 1 adds, the print line gives the
    schedule and the depth model: the adds on the longest chain of the
    schedule times one add (one_lane_dadd_ms). The JSON line keeps the last
    length's measurements and every length's under "shapes"."""
    from msm_blst_tpu_torch.curves import XyzzPoint, cuda_point
    from msm_blst_tpu_torch.msm import scan

    curve, E = case.curve, case.elem_bytes
    name = case.name("xyzz_prefix_scan")
    pts = XyzzPoint(*(curve.from_words(rows[:, i].T) for i in range(4)))
    two = cuda_point.xyzz_double_plain(
        curve, XyzzPoint(*(c[..., :1] for c in pts)))
    for c, d in zip(pts, two):
        c[..., 5::997] = 0
        c[..., 1] = c[..., 0]
        c[..., 2:3] = d
        c[..., 11] = c[..., 10]
    for i in (2, 11):
        pts.Y[..., i:i + 1] = curve.F.plain.neg(pts.Y[..., i:i + 1])
    one_ms = one_lane_dadd_ms(curve, pts)
    shapes = []
    for N in SCAN_LENGTHS:
        head = XyzzPoint(*(c[..., :N].contiguous() for c in pts))
        got = scan.prefix_scan_xyzz(curve, head)
        if N > 2 and any(bool(c[..., 2].any()) for c in (got.ZZ, got.ZZZ)):
            raise AssertionError("K4: P + P - 2P is not infinity")
        r = record(name, lambda: tuple(scan.prefix_scan_xyzz(curve, head)),
                   lambda: tuple(scan.prefix_scan_xyzz_plain(curve, head)),
                   10, 1, 8 * E * N, case.mont(DADD) * (N - 1))
        r["N"] = N
        s = scan.scan_schedule(N)
        depth = scan.scan_depth(s)
        print(f"kernel {name} N={N}: (k, tiles, k_carry) {tuple(s)}, "
              f"{1 if s.n_tiles == 1 else 3} grid launch(es) a call by the "
              f"schedule, depth {depth} adds x one add (fp.cuh's product) "
              f"{one_ms:.4f} ms = {depth * one_ms:.4f} ms")
        shapes.append(dict(r))
    r["shapes"] = shapes  # r is the kernel's entry in the JSON line


def fold_kernel(dev, case, record, rows):
    """K9 against its plain version at the CHES integration's shape: the
    six gap groups of CONFIGS[16] (engine.gap_groups) indexed into a
    109,243-point xyzz batch (`rows`: (M, 4, W) words of real sums; every
    997th lane from lane 5 set to infinity), and three more segments: P
    and P (the add doubles), P and -P (it cancels), and an empty one.
    Beside the bound, the print line gives the depth model: the adds on
    the longest thread chain, summed over the passes, times one add
    (one_lane_dadd_ms). Returns K9's sums."""
    from msm_blst_tpu_torch.curves import XyzzPoint, cuda_point
    from msm_blst_tpu_torch.msm import params, scan
    from msm_blst_tpu_torch.msm.engine import gap_groups

    curve, E = case.curve, case.elem_bytes
    M = rows.shape[0]
    pts = XyzzPoint(*(curve.from_words(rows[:, i].T) for i in range(4)))
    inf_lanes = torch.arange(5, M, 997, device=dev)
    for c in pts:
        c[..., inf_lanes] = 0
        c[..., 1] = c[..., 0]  # P, P at 0, 1
        c[..., 3] = c[..., 2]
    pts.Y[..., 3:4] = curve.F.plain.neg(pts.Y[..., 2:3])  # P, -P at 2, 3
    groups = gap_groups(np.diff(params.CONFIGS[16].bucket_set()), dev)
    last = groups.offsets[-1]
    offsets = groups.offsets + (last + 2, last + 4, last + 4)
    index = torch.cat([groups.members,
                       torch.arange(4, dtype=torch.int64, device=dev)])
    lengths = np.diff(offsets)

    def k9():
        return tuple(scan.fold_segments(curve, pts, offsets, index=index))

    def k9_plain():
        return tuple(scan.fold_segments_plain(curve, pts, offsets, index=index))

    got = k9()
    g = len(groups.offsets) - 1  # the P, P segment; then P, -P and empty
    P = XyzzPoint(*(c[..., :1] for c in pts))
    if not all(torch.equal(x[..., g:g + 1], d) for x, d in
               zip(got, cuda_point.xyzz_double_plain(curve, P))):
        raise AssertionError("K9: P + P is not 2P")
    if any(bool(x[..., g + 1:].any()) for x in got):
        raise AssertionError("K9: P - P or the empty segment is not infinity")
    record(case.name("xyzz_fold"), k9, k9_plain, 20, 1,
           int(lengths.sum()) * (4 * E + 8) + 4 * E * len(lengths),
           case.mont(DADD) * int(np.maximum(lengths - 1, 0).sum()))
    one_ms = one_lane_dadd_ms(curve, pts)
    sched = scan.fold_schedule(offsets)
    # thread 0's adds: one fewer than its elements, then every tree level
    depth = sum(
        int(-(-(t[:, 1] - t[:, 0]).max() // scan.FOLD_THREADS)) - 1
        + scan.FOLD_THREADS.bit_length() - 1 for _, t in sched)
    print(f"kernel {case.name('xyzz_fold')}: passes (k, tiles) "
          f"{[(k, len(t)) for k, t in sched]}, depth {depth} adds x one add"
          f" (fp.cuh's product) {one_ms:.4f} ms = {depth * one_ms:.4f} ms")
    return got


def horner_work(present):
    """(adds, doublings, depth in formulas) of K2's Horner combine over the
    gap groups present (integrate_gapped): each bit's part adds its groups
    in a thread of its own; then a doubling and an add a bit."""
    d_max = len(present)
    bits = d_max.bit_length()
    parts = [sum(present[g - 1] for g in range(1, d_max + 1) if g >> b & 1)
             for b in range(bits)]
    taken = [b for b in range(bits) if parts[b]]
    top = max(taken) if taken else -1
    adds = sum(max(p - 1, 0) for p in parts) + sum(1 for b in taken if b < top)
    doubles = max(top, 0)
    return adds, doubles, max(parts) - 1 + doubles + (len(taken) - 1)


def horner_kernel(dev, case, record, folded):
    """K2's Horner combine against its plain twin on the CHES integration's
    six gap groups as K9 folded them (the first six of `folded`), all
    present, as the main path runs it; the print line gives the card's time
    for it alone (queued_ms) beside its depth in formulas."""
    from msm_blst_tpu_torch.curves import XyzzPoint, cuda_point
    from msm_blst_tpu_torch.msm import params

    curve, E = case.curve, case.elem_bytes
    d_max = params.CONFIGS[N_LOG].d_max
    sums = XyzzPoint(*(c[..., :d_max].contiguous() for c in folded))
    present = [True] * d_max
    adds, doubles, depth = horner_work(present)
    name = case.name("point_gap_horner")
    record(name, lambda: tuple(cuda_point.gap_horner(curve, sums, present)),
           lambda: tuple(cuda_point.gap_horner_plain(curve, sums, present)),
           20, 2, 4 * E * (d_max + 1),
           adds * case.mont(DADD) + doubles * case.mont(DOUBLE))
    alone = queued_ms(lambda: cuda_point.gap_horner(curve, sums, present), 50)
    print(f"kernel {name}: {d_max} groups, {adds} adds and {doubles} "
          f"doublings, {depth} formulas deep; the card alone (queued) "
          f"{alone:.4f} ms")


BOUNDARY_SEED = 0  # the scalars of the recode K2's boundary launch runs on


def ches_level(curve, pts):
    """The K3 level of the CHES digit stream of one CONFIGS[16] host recode
    (scalars from BOUNDARY_SEED; 917,504 digits, key-sorted, slot s reading
    the affine point s mod 2^16 of `pts`) at stream_shape's (c, n_ch), as
    prefix_pipeline.bucket_sums_prefix forms it: (the sorted keys, the local
    prefixes, the lane tails, c, n_ch)."""
    from msm_blst_tpu_torch.msm import (cuda_scan, engine, params,
                                        prefix_pipeline, recode)

    dev = pts.X.device
    cfg = params.CONFIGS[N_LOG]
    n = 1 << N_LOG
    b, m, sg = recode.ches_recode_host(recode.random_scalars(n, BOUNDARY_SEED),
                                       cfg.c, cfg.h, cfg.ah)
    keys = params.bucket_value_to_index(cfg.q, cfg.ah)[b]
    slots = engine.ches_slots(np.arange(n)[:, None], np.arange(cfg.h)[None, :],
                              m - 1, cfg.h) % n
    keys_s, perm = torch.sort(torch.as_tensor(keys.reshape(-1), dtype=torch.int32,
                                              device=dev), stable=True)
    slots_s = torch.as_tensor(slots.reshape(-1), dtype=torch.int32,
                              device=dev)[perm]
    signs_s = torch.as_tensor(sg.reshape(-1) != 0, device=dev)[perm]
    c, n_ch = prefix_pipeline.stream_shape(keys_s.shape[0])
    slots_cm, signs_cm = prefix_pipeline.column_major_streams(slots_s, signs_s,
                                                              c, n_ch)
    rx, ry = prefix_pipeline.gather_rows(curve, curve.to_rows32(pts), slots_cm,
                                         c, n_ch)
    local, tails = cuda_scan.affine_prefix_level(curve, rx, ry,
                                                 signs_cm.reshape(c, n_ch))
    return keys_s, local, tails, c, n_ch


def boundary_kernel(dev, case, record, pts):
    """K2's bucket boundaries against their plain twin at the main path's
    shape: the CHES digit stream of one CONFIGS[16] host recode (917,504
    digits, key-sorted, over 109,244 buckets), slot s reading fixed point s
    mod 2^16 (`pts`), through K3 at stream_shape's level and K4 over its
    tails, then searchsorted for the right boundaries, as
    prefix_pipeline.buckets_from_boundaries runs them. The bound counts the
    adds this stream needs (a boundary's prefix where its lane has a carry,
    a difference where both prefixes are finite) and the bytes read once:
    the boundaries, the rows and carries they name, the buckets."""
    from msm_blst_tpu_torch.curves import cuda_point
    from msm_blst_tpu_torch.msm import params, scan

    curve, E = case.curve, case.elem_bytes
    keys_s, local, tails, c, n_ch = ches_level(curve, pts)
    incl = scan.prefix_scan_xyzz(curve, tails)
    nb = params.CONFIGS[N_LOG].b_size
    right = torch.searchsorted(keys_s, torch.arange(nb, dtype=torch.int32,
                                                    device=dev),
                               right=True, out_int32=True)
    r = right.to(torch.int64)
    kch = torch.div((r - 1).clamp(min=0), c, rounding_mode="floor")
    carried = (r > 0) & (kch > 0)
    firsts = int(carried.sum())
    seconds = int(((r[1:] > 0) & (r[:-1] > 0)).sum())
    n_bytes = (4 * nb + 4 * E * int((r > 0).sum())
               + 4 * E * int(torch.unique(kch[carried]).numel()) + 4 * E * nb)
    empty = int((r[1:] == r[:-1]).sum()) + int(r[0] == 0)
    crossing = int((kch[1:] > kch[:-1]).sum())
    print(f"kernel {case.name('point_bucket_diffs')}: {nb} buckets of a "
          f"level ({c}, {n_ch}); {empty} empty, {int((r == 0).sum())} with "
          f"the right boundary at 0, {crossing} whose boundary moves to a "
          f"later lane; {firsts} + {seconds} adds")
    record(case.name("point_bucket_diffs"),
           lambda: tuple(cuda_point.bucket_diffs(curve, right, local, incl, c,
                                                 n_ch)),
           lambda: tuple(cuda_point.bucket_diffs_plain(curve, right, local,
                                                       incl, c, n_ch)),
           20, 1, n_bytes, (firsts + seconds) * case.mont(DADD))


def seg_level_work(keys, n_buckets: int, in_bytes: int, mont_add: int,
                   elem_bytes: int = FP_BYTES):
    """(bytes, Montgomery products) of K5's level on these keys: every
    element read once; each lane writes its head and tail with their keys;
    every complete run one bucket; a column that keeps its run adds a
    point."""
    c, n_ch = keys.shape
    closing = keys[1:] != keys[:-1]
    lanes_closing = int(closing.any(dim=0).sum())
    emissions = int(closing.sum()) - lanes_closing
    n_bytes = (c * n_ch * (in_bytes + 4) + 2 * n_ch * (4 * elem_bytes + 4)
               + 4 * elem_bytes * emissions)
    return n_bytes, mont_add * int((~closing).sum())


def seg_scan_work(keys, n_buckets: int, mont_add: int, elem_bytes: int):
    """(bytes, Montgomery products, longest run) of K5's scan on these
    keys: every element and key read once, each run that reaches a bucket
    written once; one add for every element that continues a run."""
    ends = torch.ones_like(keys, dtype=torch.bool)
    ends[:-1] = keys[:-1] != keys[1:]
    runs = int(ends.sum())
    stored = int((ends & (keys >= 0) & (keys < n_buckets)).sum())
    at = torch.nonzero(ends)[:, 0]
    longest = int(torch.diff(at, prepend=at.new_full((1,), -1)).max())
    M = keys.shape[0]
    return (M * (4 * elem_bytes + 4) + 4 * elem_bytes * stored,
            mont_add * (M - runs), longest)


def seg_stream(rng, n_rows: int, N: int, c: int, n_buckets: int):
    """A key-sorted signed digit stream (slots, keys, signs as numpy) over
    n_buckets with about N / n_buckets elements per key, as BGMW's. One
    point repeats four times inside a run (a doubling) with a sign
    cancellation. At the boundaries of lanes 100 and 300 (c columns each) a
    key of its own holds one point four times, two in each lane: lane k's
    tail and lane k+1's head are 2P and 2P (lane 100) or 2P and -2P (lane
    300), which the scan adds: a doubling and a cancellation there.
    Returns the stream and those two pairs' positions in the next stream
    of interleaved heads and tails."""
    slots = rng.integers(0, n_rows, N)
    keys = np.sort(rng.integers(0, n_buckets, N))
    signs = rng.integers(0, 2, N)
    slots[10:14] = slots[10]
    keys[10:14] = keys[10]
    signs[12] = 1 - signs[11]
    meets = []
    for lane, flip in ((100, 0), (300, 1)):
        i = (lane + 1) * c
        v = keys[i]
        keys[:i - 2] = np.minimum(keys[:i - 2], v - 1)
        keys[i + 2:] = np.maximum(keys[i + 2:], v + 1)
        keys[i - 2:i + 2] = v
        slots[i - 2:i + 2] = slots[i]
        signs[i - 2:i + 2] = (0, 0, flip, flip)
        meets.append(2 * lane + 1)
    keys[-7:] = n_buckets  # pads
    return slots, keys.astype(np.int32), signs.astype(np.int32), meets


def seg_paths():
    """The segmented paths' K5 streams at n = 2^16 (CONFIGS[16]): (digits,
    buckets) of a stock window (window 13) and of BGMW (c' = 17, h' = 15),
    BGMW last."""
    from msm_blst_tpu_torch.msm import params
    from msm_blst_tpu_torch.msm.engine import pippenger_window_size

    cfg = params.CONFIGS[N_LOG]
    n = 1 << N_LOG
    return {"stock": (n, (1 << (pippenger_window_size(n) - 1)) + 1),
            "bgmw": (n * cfg.h_bgmw, (cfg.q_bgmw >> 1) + 1)}


def phase_seg_kernels(dev, case, record, rows, rng):
    """K5 against its plain version at the segmented paths' own shapes
    (seg_paths; cuda_scan.seg_level_shape, as the paths shape them): the
    affine level on real table rows (seg_stream), then the segmented scan
    on that level's own heads and tails, its bucket array included. The
    JSON line keeps BGMW's measurements (recorded last) and every path's
    under "shapes"; the print lines give the depth model (the level's c
    mixed adds, K3's one add as the unit; the scan's schedule depth and
    the stream's longest run, K4's one add as the unit) and the resident
    blocks of K5's five kernels."""
    from msm_blst_tpu_torch import kernels
    from msm_blst_tpu_torch.curves import PackedRows32, XyzzPoint
    from msm_blst_tpu_torch.msm import cuda_scan, scan

    curve, E = case.curve, case.elem_bytes
    blocks = kernels.occupancy(curve.name, "seg_level_affine")
    madd_ms = one_lane_madd_ms(curve, rows)
    shapes = {"seg_level_affine": [], "seg_scan": []}
    last = {}  # each op's entry in the JSON line: BGMW's, recorded last
    for path, (N, n_buckets) in seg_paths().items():
        c, n_ch = cuda_scan.seg_level_shape(N)
        if n_ch > scan.FOLD_WAVE * scan.FOLD_THREADS:
            raise AssertionError(f"K5 {path}: {n_ch} lanes exceed one wave")
        slots, keys, signs, meets = seg_stream(rng, rows.shape[0], N, c,
                                               n_buckets)
        stream = PackedRows32(rows.index_select(
            0, torch.as_tensor(slots, device=dev)))
        cols, sg, kc = cuda_scan.level_cols(
            curve, stream, torch.as_tensor(signs, device=dev),
            torch.as_tensor(keys, device=dev), n_buckets)
        if tuple(kc.shape) != (c, n_ch):
            raise AssertionError(f"K5 level shape {tuple(kc.shape)} != {(c, n_ch)}")
        level_buckets = cuda_scan.bucket_array(curve, n_buckets, dev)
        nxt, nkeys = cuda_scan.seg_level(curve, cols, sg, kc, level_buckets,
                                         n_buckets)
        for m in meets:  # the pair the scan doubles or cancels
            if nkeys[m] != nkeys[m + 1] or not torch.equal(nxt.X[..., m],
                                                           nxt.X[..., m + 1]):
                raise AssertionError(f"K5 scan input: no meeting pair at {m}")

        def level(fn):
            # the stores are idempotent, so repeated calls share one array
            buckets = cuda_scan.bucket_array(curve, n_buckets, dev)

            def go():
                out, out_key = fn(curve, cols, sg, kc, buckets, n_buckets)
                return tuple(buckets) + tuple(out) + (out_key,)
            return go

        def scan_run(fn):
            buckets = XyzzPoint(*(b.clone() for b in level_buckets))

            def go():
                fn(curve, nxt, nkeys, buckets, n_buckets)
                return tuple(buckets)
            return go

        r = record(case.name("seg_level_affine"), level(cuda_scan.seg_level),
                   level(cuda_scan.seg_level_plain), 5, 1,
                   *seg_level_work(kc, n_buckets, 2 * E + 4,
                                   case.mont(DADD_AFFINE), E))
        r.update(path=path, c=c, n_ch=n_ch)
        shapes["seg_level_affine"].append(dict(r))
        last["seg_level_affine"] = r
        print(f"kernel {case.name('seg_level_affine')} {path} (c, n_ch)=({c}, "
              f"{n_ch}): {-(-n_ch // 128)} blocks, depth {c} adds x one mixed "
              f"add (K3's) {madd_ms:.4f} ms = {c * madd_ms:.4f} ms; resident "
              f"blocks an SM (level, scan one-block, up, carry, down) {blocks}")
        M = nkeys.shape[0]
        sched = scan.scan_schedule(M)
        n_bytes, n_mont, longest = seg_scan_work(nkeys, n_buckets,
                                                 case.mont(DADD), E)
        r = record(case.name("seg_scan"), scan_run(cuda_scan.seg_scan),
                   scan_run(cuda_scan.seg_scan_plain), 10, 1, n_bytes, n_mont)
        r.update(path=path, M=M)
        shapes["seg_scan"].append(dict(r))
        last["seg_scan"] = r
        dadd_ms = one_lane_dadd_ms(curve, nxt)
        depth = scan.scan_depth(sched)
        print(f"kernel {case.name('seg_scan')} {path} M={M}: (k, tiles, "
              f"k_carry) {tuple(sched)}, {1 if sched.n_tiles == 1 else 3} grid "
              f"launch(es) a call, depth at most {depth} adds, longest run "
              f"{longest}; one add (fp.cuh's product) {dadd_ms:.4f} ms: "
              f"{depth * dadd_ms:.4f} ms at most")
    for op, r in last.items():
        r["shapes"] = shapes[op]


LEVEL_SHAPES = set()  # the (c, n_ch) of each K3 call since reset_counts
SEG_SHAPES = set()  # and of each K5 level
LEVEL_CALLS = []  # the (c, n_ch) of each K3 call, in order
STREAMS = []  # the length of each stream (or chunk) the prefix pipeline took


def spy_level_shapes():
    """Record the (c, n_ch) of every K3 call the paths make in LEVEL_SHAPES
    (and LEVEL_CALLS), of every K5 level in SEG_SHAPES, and the length of
    every stream or chunk of one in STREAMS (the pipelines call
    cuda_scan.affine_prefix_level, cuda_scan.seg_level and
    prefix_pipeline._bucket_sums_prefix_single through their modules)."""
    from msm_blst_tpu_torch.msm import cuda_scan, prefix_pipeline

    level = cuda_scan.affine_prefix_level
    seg = cuda_scan.seg_level
    single = prefix_pipeline._bucket_sums_prefix_single

    def spy(curve, rows_x, rows_y, sgn_cols):
        LEVEL_SHAPES.add(tuple(sgn_cols.shape))
        LEVEL_CALLS.append(tuple(sgn_cols.shape))
        return level(curve, rows_x, rows_y, sgn_cols)

    def single_spy(curve, table, slots_s, signs_s, keys_s, n_buckets):
        STREAMS.append(int(keys_s.shape[0]))
        return single(curve, table, slots_s, signs_s, keys_s, n_buckets)
    prefix_pipeline._bucket_sums_prefix_single = single_spy

    def seg_spy(curve, cols, signs, keys, buckets, n_buckets):
        SEG_SHAPES.add(tuple(keys.shape))
        return seg(curve, cols, signs, keys, buckets, n_buckets)
    cuda_scan.affine_prefix_level = spy
    cuda_scan.seg_level = seg_spy


def check_level_shapes(path: str, N: int, impl: str = "prefix"):
    """The path's level launches (K3 for the prefix strategy, K5's level for
    the segmented one) took the shape stream_shape or seg_level_shape gives
    its stream of N elements, within one wave of the level's lanes."""
    from msm_blst_tpu_torch.msm import cuda_scan, prefix_pipeline, scan

    if impl == "prefix":
        kernel, got, want = "K3", LEVEL_SHAPES, prefix_pipeline.stream_shape(N)
    else:
        kernel, got, want = "K5", SEG_SHAPES, cuda_scan.seg_level_shape(N)
    print(f"{path}: {kernel} level shapes {sorted(got)} (stream of {N})")
    if got != {want}:
        raise AssertionError(f"{path}: {kernel} ran at {sorted(got)}, not "
                             f"{want}")
    if want[1] > scan.FOLD_WAVE * scan.FOLD_THREADS:
        raise AssertionError(f"{path}: {want[1]} lanes exceed one wave")


def check_seg_launches(path: str, case, launches: dict, queries: int,
                       streams: int) -> None:
    """A segmented path launched K5's level and its scan once for each of
    the `streams` bucket passes of each query (one C call of the scan: one
    grid launch, or three)."""
    got = {op: launches[case.name(op)] for op in STRATEGY_KERNELS["segmented"]}
    print(f"{path}: K5 launches {got} ({queries} queries of {streams} bucket "
          "passes)")
    if set(got.values()) != {queries * streams}:
        raise AssertionError(f"{path}: K5 launched {got}, not "
                             f"{queries * streams} each")


def counters():
    """Each kernel, with its launch counter, by the name the JSON line gives
    it."""
    from msm_blst_tpu_torch import kernels

    return {k.name: k for k in kernels.ALL_KERNELS}


def zero_counts():
    """Every kernel's launch count and batch sizes set to 0 (the host's
    counts: no wait for the card)."""
    for k in counters().values():
        k.reset()


def reset_counts():
    torch.cuda.synchronize()
    zero_counts()
    LEVEL_SHAPES.clear()
    SEG_SHAPES.clear()
    LEVEL_CALLS.clear()
    STREAMS.clear()


def print_batches(path: str) -> None:
    """The path's K1 and K6 launches by batch size: launches and elements
    in each of kernels.SIZE_RANGES, and the commonest sizes."""
    from msm_blst_tpu_torch import kernels

    for name, k in counters().items():
        if k.batches:
            common = ", ".join(f"{size} x{count}" for size, count
                               in k.batches.most_common(4))
            print(f"{path}: {name} launches by batch size "
                  f"{kernels.size_ranges(k.batches)} "
                  f"([launches, elements]); commonest {common}")


def check_path(path: str, launches: dict, names, unused=(),
               batches: bool = False) -> dict:
    """Prints the path's launch counts `launches` (and, with `batches`, the
    counters' batch sizes); fails if one of its kernels (`names`) never
    ran, or if a kernel it must not run (`unused`: the other bucket
    strategy's, the other curve's) did."""
    print(f"{path}: launches {launches}")
    if batches:
        print_batches(path)
    idle = [name for name in names if launches[name] == 0]
    if idle:
        raise AssertionError(f"{path} never launched: {idle}")
    stray = [name for name in unused if launches[name] != 0]
    if stray:
        raise AssertionError(f"{path} launched {stray}")
    return launches


def read_counts(path: str, names, unused=()) -> dict:
    """The path's launch counts since they were set to 0, checked as
    check_path does."""
    return check_path(path, {name: k.launches for name, k in
                             counters().items()}, names, unused, batches=True)


# The kernels each query launches: the integration's suffix scans (K4)
# and folds (K9) and the conversion to Jacobian; the CHES integration's
# Horner combine (one K2 launch), the other integrations' adds and
# doublings; then those of the bucket strategy (the prefix strategy's
# boundaries: one K2 launch). By op, for either curve; K1 (mont_mul)
# serves both.
QUERY_KERNELS = ["xyzz_prefix_scan", "xyzz_fold"]
INTEGRATION_KERNELS = {"gapped": ["point_gap_horner"],
                       "weighted": ["point_dadd", "point_double"]}
STRATEGY_KERNELS = {"prefix": ["affine_prefix_level", "point_bucket_diffs"],
                    "segmented": ["seg_level_affine", "seg_scan"]}
# K2's formula launches, which a CHES query no longer makes of its own
K2_FORMULAS = ["point_dadd_affine", "point_dadd", "point_double"]
# K2's launches a CHES query makes: each once a query
CHES_K2 = ["point_bucket_diffs", "point_gap_horner"]


# The multiply each mul_impl launches for every unfused field product
MUL_KERNEL = {"cios": "mont_mul", "sos": "sos_mul"}


def path_kernels(case, ops, impl=None, mul_impl="cios", unused_ops=()):
    """(kernels the path must launch, kernels it must not), by name: the
    multiply of `mul_impl` (K1 or K6) and the curve's kernels of `ops`; not
    the other multiply, K6's partial stages, another curve's K2-K5, the
    drivers' K7 and K8, the other bucket strategy's (when `impl` is given),
    nor the curve's kernels of `unused_ops`."""
    mul = MUL_KERNEL[mul_impl]
    unused = [k.name for k in counters().values()
              if (k.op in case.kernels and k is not case.kernels[k.op])
              or (k.op in ("mont_mul", "sos_mul") and k.name != mul)
              or k.op in ("madd_chain", "gather_smem")]
    if impl is not None:
        unused += [case.name(op) for s, ops_s in STRATEGY_KERNELS.items()
                   if s != impl for op in ops_s]
    unused += [case.name(op) for op in unused_ops]
    return [mul] + [case.name(op) for op in ops], unused


def query_kernels(integration: str, impl: str):
    """The ops a query path must launch, by its integration and bucket
    strategy."""
    return (QUERY_KERNELS + INTEGRATION_KERNELS[integration]
            + STRATEGY_KERNELS[impl])


def check_ches_k2(path: str, case, launches: dict, queries: int,
                  before=None) -> None:
    """A CHES path's queries (`launches` less `before`) launched K2's
    boundary and Horner kernels once a query each, and no K2 formula of
    their own."""
    delta = {op: launches[case.name(op)] - (before or {}).get(case.name(op), 0)
             for op in CHES_K2 + K2_FORMULAS}
    want = {op: queries if op in CHES_K2 else 0 for op in delta}
    print(f"{path}: K2 launches of the queries {delta} ({queries} queries)")
    if delta != want:
        raise AssertionError(f"{path}: K2 launched {delta}, not {want}")


def per_query(path: str, case, launches: dict, queries: int,
              before=None) -> None:
    """The path's K2 dadd, K9 and K4 launches a query, K2's boundary and
    Horner launches and K5's (less those counted in `before`, a snapshot
    taken before the queries)."""
    for name in (case.name("point_dadd"), case.name("xyzz_fold"),
                 case.name("xyzz_prefix_scan"),
                 *(case.name(op) for op in CHES_K2),
                 *(case.name(op) for op in STRATEGY_KERNELS["segmented"])):
        n = launches[name] - (before or {}).get(name, 0)
        print(f"{path}: {name} launches a query: {n / queries:g}")


def oracle_check(case, n: int):
    """check(seed, jac, curve): the query's result must be the oracle's
    (sum s_i 2^(i+1) mod r) * G for the scalars of `seed`; `curve` (the
    plan's, by default the case's) converts it to affine, so a path's
    check runs on the path's own multiply."""
    from msm_blst_tpu_torch import refimpl
    from msm_blst_tpu_torch.constants import R_ORDER
    from msm_blst_tpu_torch.msm import recode

    ref = refimpl.CURVES[case.curve.name]
    weights = [pow(2, i + 1, R_ORDER) for i in range(n)]

    def check(seed, jac, curve=case.curve):
        ints = recode.scalars_to_ints(recode.random_scalars(n, seed))
        total = sum(s * e for s, e in zip(ints, weights)) % R_ORDER
        got = curve.affine_to_ints(curve.jac_to_affine(jac))[0]
        if got != ref.mult(total):
            raise AssertionError(f"{case.curve.name} seed {seed}: MSM "
                                 "differs from the oracle")
    return check


def phase_main_path(dev, case, mul_impl="cios", seeds=SEEDS):
    """The CHES device-recode query at n = 2^16 (CONFIGS[16]): fixed
    points, the CHES-only plan, one warm-up and the timed scalar sets
    `seeds`, every unfused field product (plan build included) on the
    multiply of `mul_impl`."""
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_ches_device, params, recode)

    curve = case.curve
    label = f"{curve.name} main path" + (
        "" if mul_impl == "cios" else f" ({mul_impl} multiply)")
    n = 1 << N_LOG
    cfg = params.CONFIGS[N_LOG]
    check = oracle_check(case, n)
    scalars = {s: recode.to_device(recode.random_scalars(n, s), dev)
               for s in (WARM_SEED,) + seeds}
    reset_counts()
    t0 = time.perf_counter()
    points = fixed_point_list(curve, n, device=dev, mul_impl=mul_impl)
    plan = build_plan(curve, points, cfg, bgmw=False, stock=False,
                      mul_impl=mul_impl)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"{label}: n=2^{N_LOG}, c={cfg.c}, h={cfg.h}, |B|={cfg.b_size}, "
          f"table {tuple(plan.table3nh.XY.shape)}; fixed points + plan "
          f"{build_s:.3f} s")
    built = {name: k.launches for name, k in counters().items()}
    check(WARM_SEED, msm_ches_device(plan, scalars[WARM_SEED]), plan.curve)
    times = []
    for s in seeds:
        torch.cuda.synchronize()
        t = time.perf_counter()
        jac = msm_ches_device(plan, scalars[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        check(s, jac, plan.curve)
    print(f"{label}: {len(seeds)} queries equal to the oracle; query mean "
          f"{1e3 * sum(times) / len(times):.3f} ms, min {1e3 * min(times):.3f}"
          f" ms")
    launches = read_counts(label, *path_kernels(
        case, K2_FORMULAS + query_kernels("gapped", "prefix"), "prefix",
        mul_impl))
    check_level_shapes(label, n * cfg.h)
    per_query(label, case, launches, 1 + len(seeds), built)
    check_ches_k2(label, case, launches, 1 + len(seeds), built)
    return launches


def phase_algorithms(dev, case, seeds):
    """Host-recode CHES, BGMW95 and stock Pippenger at n = 2^16 on one plan
    holding all three tables, BGMW and stock with both bucket strategies
    (stock on all but the last of `seeds`). The plan build and each
    query path count their launches on their own (counts set to 0 just
    before, read just after). Returns the counts by path."""
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_bgmw_device, msm_ches_host_recode,
                                        msm_stock_pippenger, params, recode)
    from msm_blst_tpu_torch.msm.engine import pippenger_window_size

    curve = case.curve
    label = f"{curve.name} algorithms"
    n = 1 << N_LOG
    cfg = params.CONFIGS[N_LOG]
    check = oracle_check(case, n)
    host = {s: recode.random_scalars(n, s) for s in (WARM_SEED,) + seeds}
    scalars = {s: recode.to_device(a, dev) for s, a in host.items()}
    reset_counts()
    t0 = time.perf_counter()
    plan = build_plan(curve, fixed_point_list(curve, n, device=dev), cfg)
    torch.cuda.synchronize()
    print(f"{label}: n=2^{N_LOG}, plan with 3nh {tuple(plan.table3nh.XY.shape)},"
          f" nh {tuple(plan.table_nh.XY.shape)} (c'={cfg.c_bgmw}, "
          f"h'={cfg.h_bgmw}), points; fixed points + plan "
          f"{time.perf_counter() - t0:.3f} s")
    paths = {f"{curve.name}_algorithms_plan": read_counts(
        f"{label} plan", *path_kernels(
            case, ["point_dadd_affine", "point_dadd", "point_double"]))}
    stock_seeds = seeds[:max(1, len(seeds) - 1)]
    # (name, integration, bucket strategy, query, timed seeds, digits a
    # bucket pass, bucket passes a query)
    windows = -(-256 // pippenger_window_size(n))  # stock's (nbits 255)
    queries = [
        ("ches_host_recode", "gapped", "prefix", lambda s: msm_ches_host_recode(
            plan, host[s], bucket_impl="prefix"), seeds, n * cfg.h, 1),
        ("bgmw_prefix", "weighted", "prefix", lambda s: msm_bgmw_device(
            plan, scalars[s], bucket_impl="prefix"), seeds, n * cfg.h_bgmw, 1),
        ("bgmw_segmented", "weighted", "segmented", lambda s: msm_bgmw_device(
            plan, scalars[s], bucket_impl="segmented"), seeds,
         n * cfg.h_bgmw, 1),
        ("stock_prefix", "weighted", "prefix", lambda s: msm_stock_pippenger(
            plan, scalars[s], bucket_impl="prefix"), stock_seeds, n, windows),
        ("stock_segmented", "weighted", "segmented",
         lambda s: msm_stock_pippenger(plan, scalars[s],
                                       bucket_impl="segmented"),
         stock_seeds, n, windows),
    ]
    for name, integration, impl, query, qseeds, stream, passes in queries:
        reset_counts()
        check(WARM_SEED, query(WARM_SEED))
        times = []
        for s in qseeds:
            torch.cuda.synchronize()
            t = time.perf_counter()
            jac = query(s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(s, jac)
        print(f"{label}: {name}: {len(qseeds)} queries equal to the oracle;"
              f" query mean {1e3 * sum(times) / len(times):.3f} ms, min "
              f"{1e3 * min(times):.3f} ms")
        other = [op for i, ops in INTEGRATION_KERNELS.items()
                 if i != integration for op in ops]
        if integration == "gapped":
            other += K2_FORMULAS
        paths[f"{curve.name}_{name}"] = read_counts(
            f"{label} {name}", *path_kernels(
                case, query_kernels(integration, impl), impl,
                unused_ops=other))
        check_level_shapes(f"{label} {name}", stream, impl)
        per_query(f"{label} {name}", case, paths[f"{curve.name}_{name}"],
                  1 + len(qseeds))
        if impl == "segmented":
            check_seg_launches(f"{label} {name}", case,
                               paths[f"{curve.name}_{name}"], 1 + len(qseeds),
                               passes)
        if integration == "gapped":
            check_ches_k2(f"{label} {name}", case,
                          paths[f"{curve.name}_{name}"], 1 + len(qseeds))
    return paths


# The harness phase: the reference's harness (drivers/run_msm.py) over its
# five methods, the two stage profilers, the flagship entry and curves/mult.py
HARNESS_REPS = {"G1": 2, "G2": 1}  # run_msm's scalar sets, by curve
PROFILE_LOG = 16  # profile_stages' n
BIGN_PROFILE_LOG = 19  # bign_profile's n (its JAX default)
MULT_LANES = {"G1": 256, "G2": 64}
# the K2 formulas each function of curves/mult.py launches (the ladder's XZ
# formulas run on K1 alone); the others it must not
MULT_OPS = {"point_mult": ["point_double", "point_dadd_affine"],
            "ladder_mult": [],
            "msm_wbits": ["point_double", "point_dadd_affine", "point_dadd"],
            "points_add": ["point_dadd"]}
RUN_MSM_PATHS = {  # run_msm's method -> its path's name after the curve's
    "CHES q/5 (host conversion)": "run_msm_ches_host_recode",
    "CHES q/5 (integral device conversion)": "run_msm_ches_device",
    "CHES q/5 noindexhash": "run_msm_ches_noindexhash",
    "BGMW95 q/2": "run_msm_bgmw",
    "stock Pippenger (no precompute)": "run_msm_stock",
}
# each run_msm path's integration (a "gapped" one, CHES, launches no K2
# formula of its own)
RUN_MSM_KINDS = {"run_msm_ches_host_recode": "gapped",
                 "run_msm_ches_device": "gapped",
                 "run_msm_ches_noindexhash": "gapped",
                 "run_msm_bgmw": "weighted", "run_msm_stock": "weighted"}


def method_counter(prefix: str, paths: dict):
    """run_msm's `around`: each method's calls counted as a path of its own
    (`prefix`_RUN_MSM_PATHS[method]), the counts set to 0 just before each
    call and added to the path's just after."""
    import contextlib

    @contextlib.contextmanager
    def around(name):
        zero_counts()
        yield
        path = paths.setdefault(f"{prefix}_{RUN_MSM_PATHS[name]}",
                                {n: 0 for n in counters()})
        for n, k in counters().items():
            path[n] += k.launches
    return around


def harness_run_msm(dev, case, cache_dir=None) -> dict:
    """run_msm.main at CONFIGS[16] over the five methods (the oracle
    checked, every method equal to the others, or the driver exits 1); each
    method's launches a path of its own, holding the kernels of its query
    and, for the CHES ones, K2's boundary and Horner launches once a query
    and no K2 formula of their own; the noindexhash path launches the same
    kernels as the index-keyed CHES path."""
    from msm_blst_tpu_torch.drivers import run_msm

    name = case.curve.name
    reps = HARNESS_REPS[name]
    argv = ["--group", name[1], "--config", str(N_LOG), "--reps", str(reps),
            "--oracle", "--json", "--device", str(dev)]
    if cache_dir:
        argv += ["--cache-dir", cache_dir]
    paths = {}
    t0 = time.perf_counter()
    rec = run_msm.main(argv, around=method_counter(name, paths))
    print(f"{name} harness run_msm: {time.perf_counter() - t0:.3f} s; means "
          f"(us) {rec['means_us']}, host conversion {rec['conversion_us']:.1f}"
          " us")
    queries = 2 * reps  # each set: a warm-up and one timed loop of one
    for path, launches in paths.items():
        kind = RUN_MSM_KINDS[path[len(name) + 1:]]
        other = [op for i, ops in INTEGRATION_KERNELS.items() if i != kind
                 for op in ops] + (K2_FORMULAS if kind == "gapped" else [])
        check_path(path, launches, *path_kernels(
            case, query_kernels(kind, "prefix"), "prefix", unused_ops=other))
        per_query(path, case, launches, queries)
        if kind == "gapped":
            check_ches_k2(path, case, launches, queries)
    used = {p: {n for n, v in paths[f"{name}_{p}"].items() if v}
            for p in ("run_msm_ches_device", "run_msm_ches_noindexhash")}
    if used["run_msm_ches_device"] != used["run_msm_ches_noindexhash"]:
        raise AssertionError(f"{name}: the noindexhash path launched "
                             f"{sorted(used['run_msm_ches_noindexhash'])}, the"
                             f" CHES path {sorted(used['run_msm_ches_device'])}")
    return paths


def harness_noindexhash_segmented(dev, case, cache_dir) -> dict:
    """The noindexhash CHES query with the segmented strategy on the plan
    run_msm cached (loaded back): against the oracle, launching K5's level
    (at seg_level_shape) and scan once a query, never K3."""
    import dataclasses

    from msm_blst_tpu_torch.msm import load_plan, msm_ches_device, params

    n, cfg = 1 << N_LOG, params.CONFIGS[N_LOG]
    label = f"{case.curve.name} noindexhash segmented"
    plan = load_plan(case.curve, cfg, n, cache_dir, device=dev)
    nih = dataclasses.replace(plan, noindexhash=True)
    bc = BignCase(case, n, (WARM_SEED,) + G2_BIGN_SEEDS, dev)
    reset_counts()
    query = functools.partial(msm_ches_device, nih, bucket_impl="segmented")
    bc.check(label, WARM_SEED, query(bc.scalars[WARM_SEED]), nih.curve)
    times = []
    for s in G2_BIGN_SEEDS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        jac = query(bc.scalars[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        bc.check(label, s, jac, nih.curve)
    print(f"{label}: {len(times)} queries equal to the oracle; query mean "
          f"{1e3 * sum(times) / len(times):.3f} ms ({(cfg.q >> 1) + 2} value "
          "buckets)")
    launches = read_counts(label, *path_kernels(
        case, query_kernels("gapped", "segmented"), "segmented",
        unused_ops=K2_FORMULAS))
    check_level_shapes(label, n * cfg.h, "segmented")
    queries = 1 + len(times)
    check_seg_launches(label, case, launches, queries, 1)
    per_query(label, case, launches, queries)
    return launches


def harness_profilers(dev) -> dict:
    """profile_stages at n = 2^16 and bign_profile at 2^19 (CHES and
    BGMW95) on G1, each a path of its own and printing its JSON line."""
    from msm_blst_tpu_torch.drivers import bign_profile, profile_stages

    g1 = CurveCase("G1")
    paths = {}
    reset_counts()
    t0 = time.perf_counter()
    profile_stages.main(["--n-exp", str(PROFILE_LOG), "--device", str(dev)])
    print(f"G1 profile_stages 2^{PROFILE_LOG}: {time.perf_counter() - t0:.3f} s")
    paths[f"G1_profile_stages_2^{PROFILE_LOG}"] = read_counts(
        "G1 profile_stages", *path_kernels(
            g1, query_kernels("gapped", "prefix"), "prefix"))
    for algo, kind in (("ches", "gapped"), ("bgmw", "weighted")):
        reset_counts()
        t0 = time.perf_counter()
        bign_profile.main(["--n-exp", str(BIGN_PROFILE_LOG), "--algo", algo,
                           "--device", str(dev)])
        print(f"G1 bign_profile 2^{BIGN_PROFILE_LOG} {algo}: "
              f"{time.perf_counter() - t0:.3f} s")
        paths[f"G1_bign_profile_{algo}_2^{BIGN_PROFILE_LOG}"] = read_counts(
            f"G1 bign_profile {algo}", *path_kernels(
                g1, query_kernels(kind, "prefix"), "prefix"))
        torch.cuda.empty_cache()
    return paths


def harness_entry(dev) -> dict:
    """entry(): fn(*example_args) on the card against the oracle."""
    from msm_blst_tpu_torch.entry import entry

    g1 = CurveCase("G1")
    reset_counts()
    fn, args = entry()
    jac = fn(*args)
    if args[0].device.type != "cuda":
        raise AssertionError("entry() did not default to the card")
    oracle_check(g1, 64)(7, jac)
    print("G1 entry: fn(*example_args) on the card equals the oracle")
    return read_counts("G1 entry", *path_kernels(
        g1, query_kernels("gapped", "prefix"), "prefix"))


def outside_subgroup():
    """A point of y^2 = x^3 + 4 over Fp that r does not kill (the first from
    x = 2 on; p = 3 mod 4, so y = a^((p+1)/4) when a is a square)."""
    from msm_blst_tpu_torch import refimpl
    from msm_blst_tpu_torch.constants import P, R_ORDER

    ref = refimpl.G1
    x = 1
    while True:
        x += 1
        a = (x * x * x + 4) % P
        y = pow(a, (P + 1) // 4, P)
        if y * y % P != a:
            continue
        acc = ref.INF
        for bit in bin(R_ORDER)[2:]:
            acc = ref.add(acc, acc)
            if bit == "1":
                acc = ref.add(acc, (x, y))
        if acc != ref.INF:
            return x, y


def harness_mult(dev, case) -> dict:
    """curves/mult.py on the card, MULT_LANES lanes of fixed points: the
    scalars 0, 1 and r - 1 in lanes 0-2 and the point at infinity in lane
    3; point_mult and ladder_mult lane by lane, msm_wbits and points_add
    (the sum) and in_group_device (G1 with a point outside the subgroup in
    lane 4) against the oracle; each a path, with its K1 and K2 launches by
    batch size."""
    from msm_blst_tpu_torch import refimpl
    from msm_blst_tpu_torch.constants import R_ORDER
    from msm_blst_tpu_torch.curves import (AffinePoint, in_group_device,
                                           ladder_mult, msm_wbits, point_mult,
                                           points_add)
    from msm_blst_tpu_torch.msm import fixed_point_list, recode

    curve = case.curve
    name, n = curve.name, MULT_LANES[curve.name]
    ref = refimpl.CURVES[name]
    pts = fixed_point_list(curve, n, device=dev)
    inf = torch.arange(n, device=dev) == 3
    pts = AffinePoint(*(torch.where(inf, 0, c) for c in pts))
    ks = recode.scalars_to_ints(recode.random_scalars(n, 41))
    ks[:3] = [0, 1, R_ORDER - 1]
    sc = recode.to_device(recode.scalars_from_ints(ks), dev)
    e = [0 if i == 3 else pow(2, i + 1, R_ORDER) for i in range(n)]
    lanes = [ref.mult(k * ei % R_ORDER) for k, ei in zip(ks, e)]
    total = ref.mult(sum(k * ei for k, ei in zip(ks, e)) % R_ORDER)
    in_group = [True] * n
    if name == "G1":
        bad = curve.affine_from_ints([outside_subgroup()], device=dev)
        pts = AffinePoint(*(torch.cat([c[:, :4], b, c[:, 5:]], dim=1)
                            for c, b in zip(pts, bad)))
        in_group[4] = False
    # the lanes the oracle's points are on (G1's lane 4 is not)
    keep = [i for i in range(n) if name != "G1" or i != 4]
    on = AffinePoint(*(c[..., keep] for c in pts))
    wbits = ref.mult(sum(ks[i] * e[i] for i in keep) % R_ORDER)
    calls = [  # (function, call, the oracle's affine points at `keep`)
        ("point_mult", lambda: point_mult(curve, sc, pts),
         [lanes[i] for i in keep]),
        ("ladder_mult", lambda: ladder_mult(curve, sc, pts),
         [lanes[i] for i in keep]),
        ("msm_wbits", lambda: msm_wbits(curve, sc[:, keep], on), [wbits]),
        ("points_add", lambda: points_add(curve, on),
         [ref.mult(sum(e[i] for i in keep) % R_ORDER)]),
    ]
    paths = {}
    for fn_name, call, want in calls:
        reset_counts()
        t0 = time.perf_counter()
        jac = call()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = curve.affine_to_ints(curve.jac_to_affine(jac))
        if len(want) > 1:
            got = [got[i] for i in keep]
        if got != want:
            raise AssertionError(f"{name} {fn_name}: differs from the oracle")
        label = f"{name} mult {fn_name}"
        print(f"{label}: {len(keep)} lanes equal to the oracle; {ms:.3f} ms")
        paths[f"{name}_mult_{fn_name}"] = read_counts(
            label, *path_kernels(case, MULT_OPS[fn_name],
                                 unused_ops=[op for op in K2_FORMULAS
                                             if op not in MULT_OPS[fn_name]]))
    reset_counts()
    t0 = time.perf_counter()
    mask = in_group_device(curve, pts).tolist()
    print(f"{name} mult in_group_device: {mask.count(True)} of {n} lanes in "
          f"the group, {1e3 * (time.perf_counter() - t0):.3f} ms")
    if mask != in_group:
        raise AssertionError(f"{name} in_group_device: {mask} != {in_group}")
    paths[f"{name}_mult_in_group_device"] = read_counts(
        f"{name} mult in_group_device",
        *path_kernels(case, MULT_OPS["point_mult"], unused_ops=["point_dadd"]))
    return paths


def phase_harness(dev, g1, g2):
    """The reference's harness on the port: run_msm over its five methods
    (G1: CONFIGS[16], two scalar sets, the plan cached and loaded back for
    the noindexhash query under the segmented strategy; G2: one set), the
    two stage profilers, entry() and curves/mult.py on both curves.
    Returns the launch counts by path."""
    import tempfile

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as d:
        paths.update(harness_run_msm(dev, g1, d))
        paths["G1_noindexhash_segmented"] = harness_noindexhash_segmented(
            dev, g1, d)
    torch.cuda.empty_cache()
    paths.update(harness_run_msm(dev, g2))
    torch.cuda.empty_cache()
    paths.update(harness_profilers(dev))
    paths["G1_entry"] = harness_entry(dev)
    for case in (g1, g2):
        paths.update(harness_mult(dev, case))
    print(f"harness phase: {time.perf_counter() - t0:.3f} s")
    return paths


# The protocol phase: batched hash to curve (protocol/device_map.py)
H2C_G1_MSGS = 4096  # hash_to_g1_device's messages: 8,192 SSWU lanes
H2C_G2_US = 2048  # map_to_g2_device's u values: 1,024 messages' field half
H2C_SEED = 16  # the seed of the messages and u values
H2C_TIMED = 2  # timed batches of each path, after one warm-up
# the K2 formulas the G1 path launches: the u0 + u1 add, then point_mult's
# table, doublings and adds; the G2 path launches none (K1 alone)
H2C_OPS = {"G1": ["point_double", "point_dadd_affine"], "G2": []}


def h2c_messages(n: int, seed: int) -> list:
    """n distinct seeded messages of 0 to 63 bytes, the batch index in the
    first four bytes."""
    rng = np.random.default_rng(seed)
    return [i.to_bytes(4, "big") + rng.bytes(int(k))
            for i, k in enumerate(rng.integers(0, 60, n))]


def h2c_g2_us(n: int, seed: int) -> list:
    """n seeded Fp2 u values, the edge lanes first: u = 0 (tv2 = 0, the
    exceptional x1), c0 = 0 (sgn0's second branch) and u in Fp."""
    from msm_blst_tpu_torch.constants import P

    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(64), "little") % P for _ in range(2 * n)]
    return ([(0, 0), (0, 5), (7, 0)] + list(zip(rand[0::2], rand[1::2])))[:n]


def timed_batch(fn):
    """(fn(), wall ms, device ms): the host's clock and the card's CUDA
    events around one call, the card idle before it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t), start.elapsed_time(end)


def h2c_edges(dev):
    """The edge lanes on the card against the host oracle: map_to_g1_device
    (cleared and not) on u = 0, 1, p - 1 and u whose g(x1) is and is not a
    square; hash_to_g1_device's body on u pairs whose maps are equal (K2's
    add doubles), opposite (it cancels) and u0 = u1 = 0; the Fp2 square
    root on -1 and -25 (alpha == -1), 0 and a non-residue."""
    from msm_blst_tpu_torch.constants import P
    from msm_blst_tpu_torch.curves import G1
    from msm_blst_tpu_torch.fields import FP, FP2
    from msm_blst_tpu_torch.protocol import device_map as dm
    from msm_blst_tpu_torch.protocol import hash_to_curve as h2c
    from msm_blst_tpu_torch.refimpl import G1_REF, Fp, Fp2

    a, b, z = h2c._G1_A, h2c._G1_B, h2c._G1_Z
    us, kinds, u = [0, 1, P - 1], {}, 1
    while len(kinds) < 2:  # the first u from 2 on of each kind
        u += 1
        tv1 = z * Fp(u).sqr()
        x1 = (-b) * a.inv() * ((tv1.sqr() + tv1).inv() + Fp.one())
        sq = h2c.is_square_fp((x1.sqr() + a) * x1 + b)
        if sq not in kinds:
            kinds[sq] = u
            us.append(u)
    on_e1 = [h2c.map_to_curve_g1(Fp(x)) for x in us]
    want = {False: [(p[0].v, p[1].v) for p in on_e1],
            True: [tuple(c.v for c in h2c.clear_cofactor_g1(p))
                   for p in on_e1]}
    for clear in (False, True):
        got = G1.affine_to_ints(dm.map_to_g1_device(
            FP.from_ints(us, device=dev), clear_cofactor=clear, device=dev))
        if got != want[clear]:
            raise AssertionError(f"protocol edges: map_to_g1_device(clear="
                                 f"{clear}) differs from the oracle")
    pairs = [(us[3], us[3]), (us[4], P - us[4]), (0, 0)]
    got = G1.affine_to_ints(dm._run_hash_to_g1(FP.from_ints(
        [x for pair in pairs for x in pair], device=dev)))
    for (u0, u1), pt in zip(pairs, got):
        q = G1_REF.jac_add(*(G1_REF.from_affine(h2c.map_to_curve_g1(Fp(x)))
                             for x in (u0, u1)))
        w = h2c.clear_cofactor_g1(G1_REF.to_affine(q))
        if pt != (w[0].v, w[1].v):
            raise AssertionError(f"protocol edges: the pair {(u0, u1)} "
                                 "differs from the oracle")
    if got[1] != (0, 0):
        raise AssertionError("protocol edges: the opposite pair did not cancel")
    vals = [(P - 1, 0), (P - 25, 0), (0, 0), (3, 5)]
    root, ok = dm._sqrt_fp2_device(FP2.from_int_pairs(vals, device=dev))
    roots = FP2.to_int_pairs(root)
    for v, r, good in zip(vals, roots, ok.tolist()):
        host = h2c.sqrt_fp2(Fp2(*v))
        if good != (host is not None) or (good and Fp2(*r).sqr() != Fp2(*v)):
            raise AssertionError(f"protocol edges: the Fp2 root of {v}")
    print(f"protocol edges: map_to_g1_device on u = 0, 1, p - 1, "
          f"{kinds[True]} (g(x1) a square) and {kinds[False]} (not), the "
          f"doubling, cancelling and u = 0 "
          f"pairs, the Fp2 root of -1, -25, 0 and a non-residue "
          f"({ok.tolist()}) equal the host oracle")


def h2c_path(label, run, n_in, unit, check_lanes):
    """One warm-up and H2C_TIMED timed calls of `run`, every output held
    to the oracle by `check_lanes`; prints each batch's wall and device ms
    and the us a `unit`; returns the last output."""
    out, _, _ = timed_batch(run)
    check_lanes(out, "warm-up")
    for i in range(H2C_TIMED):
        out, wall, dev_ms = timed_batch(run)
        check_lanes(out, f"batch {i}")
        print(f"{label}: batch {i}: {wall:.3f} ms wall, {dev_ms:.3f} ms "
              f"device_ms, {1e3 * wall / n_in:.3f} us a {unit}")
    return out


def phase_protocol(dev, g1, g2):
    """hash_to_g1_device over H2C_G1_MSGS messages and map_to_g2_device
    over H2C_G2_US u values (the edge lanes first), each one warm-up and
    H2C_TIMED timed batches, every lane against the port's host oracle
    (hash_to_g1, map_to_curve_g2), every G1 lane in the group by
    in_group_device; each path a path of its own, launching K1 (and on G1
    K2's doubling and mixed add) and nothing else, with K1's launches by
    batch size. The edge lanes of G1 run first (h2c_edges)."""
    from msm_blst_tpu_torch.curves import in_group_device
    from msm_blst_tpu_torch.fields import FP2
    from msm_blst_tpu_torch.protocol import device_map as dm
    from msm_blst_tpu_torch.protocol import hash_to_curve as h2c
    from msm_blst_tpu_torch.refimpl import Fp2

    t0 = time.perf_counter()
    print(f"protocol phase on {card_line()}")
    h2c_edges(dev)
    paths = {}
    msgs = h2c_messages(H2C_G1_MSGS, H2C_SEED)
    us = h2c_g2_us(H2C_G2_US, H2C_SEED)
    t = time.perf_counter()
    want_g1 = [h2c.hash_to_g1(m) for m in msgs]
    t_g1 = time.perf_counter() - t
    t = time.perf_counter()
    want_g2 = []
    for u in us:
        x, y = h2c.map_to_curve_g2(Fp2(*u))
        want_g2.append(((x.c0.v, x.c1.v), (y.c0.v, y.c1.v)))
    t_g2 = time.perf_counter() - t
    print(f"protocol host oracle: hash_to_g1 of {len(msgs)} messages "
          f"{t_g1:.3f} s, map_to_curve_g2 of {len(us)} u values {t_g2:.3f} s")
    for case, n_in, unit, run, want in (
            (g1, len(msgs), "message",
             lambda: dm.hash_to_g1_device(msgs, device=dev), want_g1),
            (g2, len(us), "u value",
             lambda: dm.map_to_g2_device(FP2.from_int_pairs(us, device=dev),
                                         device=dev), want_g2)):
        curve = case.curve
        label = ("G1 hash_to_g1_device" if curve.name == "G1"
                 else "G2 map_to_g2_device")

        def check_lanes(out, which, curve=curve, want=want, label=label):
            got = curve.affine_to_ints(out)
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            if bad or len(got) != len(want):
                raise AssertionError(f"{label} {which}: lanes {bad[:8]} "
                                     "differ from the host oracle")

        reset_counts()
        out = h2c_path(label, run, n_in, unit, check_lanes)
        print(f"{label}: {1 + H2C_TIMED} batches of {n_in} lanes equal to "
              "the host oracle")
        ops = H2C_OPS[curve.name]
        path = ("G1_hash_to_g1" if curve.name == "G1" else "G2_map_to_g2")
        launches = read_counts(label, *path_kernels(
            case, ops, unused_ops=[op for op in case.kernels
                                   if op not in ops]))
        for name in ["mont_mul"] + [case.name(op) for op in ops]:
            print(f"{label}: {name} launches a batch: "
                  f"{launches[name] / (1 + H2C_TIMED):g}")
        paths[path] = launches
        if curve.name == "G1":
            t = time.perf_counter()
            mask = in_group_device(curve, out).tolist()
            if not all(mask):
                raise AssertionError(f"{label}: lanes outside G1: "
                                     f"{[i for i, m in enumerate(mask) if not m][:8]}")
            print(f"{label}: all {len(mask)} points in G1 (in_group_device, "
                  f"{time.perf_counter() - t:.3f} s)")
        torch.cuda.empty_cache()
    print(f"protocol phase: {time.perf_counter() - t0:.3f} s")
    return paths


# The facade phase: the blst-named API (msm_blst_tpu_torch/api.py) on the
# card at n = 2^16 (CONFIGS[16]), G1 and G2, on the reference's points
FACADE_SEEDS = (2, 3, 4)  # the CHES repeat calls' scalar sets
FACADE_BGMW_SEED = 5  # the BGMW call's, and the CHES call after it
FACADE_OFF_N = 100_000  # the off-table n of one G1 CHES call
FACADE_WBITS, FACADE_WBITS_LOG = 5, 12  # wbits' window and its 2^12 points
FACADE_TILE_WINDOW = 13
FACADE_INF_LANES = (5, 777, 40_000)  # the infinity lanes of the batch ops
# A position the JAX facade's 16 digest probes (0, n/16, 2n/16, ...) never
# read: its point is replaced in place, and the next CHES call must see it
FACADE_C2_POS = 1
# the facade's helpers each call's time is split over (the rest: the query)
FACADE_PARTS = ("_ches_plan", "_points_digest", "_device_affine",
                "build_plan", "_scalars_device", "_jac_ints")


class FacadeTimer:
    """Wraps FACADE_PARTS of the facade module with timers that finish the
    card's queued work on entry and on exit, so each part's seconds are its
    own (`parts`, summed since `clear`); `call(fn)` times one whole call."""

    def __init__(self):
        from msm_blst_tpu_torch import api

        self.api, self.parts, self.saved = api, {}, {}
        for name in FACADE_PARTS:
            fn = getattr(api, name)
            self.saved[name] = fn
            setattr(api, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.parts[name] = (self.parts.get(name, 0.0)
                                + time.perf_counter() - t)
            return out
        return wrapper

    def clear(self):
        self.parts = {}

    def call(self, fn):
        """(fn(), its seconds, its parts' seconds), the card idle before."""
        self.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, dict(self.parts)

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.api, name, fn)


def split_line(total, parts) -> str:
    """A call's seconds and its parts' (the plan memo and upgrade: the
    whole _ches_plan less the digest, the conversion and build_plan inside
    it; the query: the rest)."""
    get = parts.get
    plan = (get("_ches_plan", 0.0) - get("_points_digest", 0.0)
            - get("_device_affine", 0.0) - get("build_plan", 0.0))
    named = {"digest": get("_points_digest", 0.0),
             "point conversion": get("_device_affine", 0.0),
             "plan build": get("build_plan", 0.0),
             "plan memo and upgrade": max(plan, 0.0),
             "scalars": get("_scalars_device", 0.0),
             "result to ints": get("_jac_ints", 0.0)}
    rest = total - sum(named.values())
    return (f"{1e3 * total:.3f} ms: " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in named.items() if v)
        + f", query {1e3 * rest:.3f} ms")


class FacadeCase:
    """One curve's facade inputs at n points: the reference's fixed points
    P_i = 2^(i+1) G as host int tuples, and by seed the scalars as host
    ints and the oracle's affine point; the facade's names by prefix."""

    def __init__(self, case, n: int, seeds, dev):
        from msm_blst_tpu_torch import api, refimpl
        from msm_blst_tpu_torch.constants import R_ORDER
        from msm_blst_tpu_torch.msm import fixed_point_list, recode

        curve = case.curve
        self.case, self.n, self.api = case, n, api
        self.p = "p1" if curve.name == "G1" else "p2"
        self.ref = refimpl.CURVES[curve.name]
        t0 = time.perf_counter()
        self.points = curve.affine_to_ints(fixed_point_list(curve, n,
                                                             device=dev))
        host = {s: bign_scalars(n, s) for s in seeds}
        self.ints = {s: recode.scalars_to_ints(a) for s, a in host.items()}
        self.totals = {s: weighted_total(a) for s, a in host.items()}
        self.want = {s: self.ref.mult(t) for s, t in self.totals.items()}
        self.weights = None  # set when a point is replaced (replace)
        self.r = R_ORDER
        print(f"{curve.name} facade: {n} fixed points and {len(seeds)} "
              f"scalar sets on the host, {time.perf_counter() - t0:.3f} s")

    def fn(self, name):
        return getattr(self.api, f"{self.p}{name}")

    def replace(self, pos: int, k: int):
        """Point `pos` becomes k * G in place (the same list object); the
        oracle follows."""
        e = pow(2, pos + 1, self.r)
        self.points[pos] = self.ref.mult(k)
        for s, ints in self.ints.items():
            self.totals[s] = (self.totals[s] + ints[pos] * (k - e)) % self.r
            self.want[s] = self.ref.mult(self.totals[s])

    def check(self, label, seed, jac):
        got = self.fn("_to_affine")(jac)
        if got != self.want[seed]:
            raise AssertionError(f"{label} seed {seed}: differs from the "
                                 "oracle")


def facade_counts():
    return {name: k.launches for name, k in counters().items()}


def facade_path(label, case, ops, integration=None, impl=None) -> dict:
    """The path's launches since reset_counts, checked as read_counts does:
    the kernels of `ops` (and of the query of `integration`, on the bucket
    strategy `impl`) launched, the other integration's and strategy's
    not."""
    unused = []
    if integration is not None:
        ops = ops + query_kernels(integration, impl)
        unused = [op for i, o in INTEGRATION_KERNELS.items()
                  if i != integration for op in o]
        if integration == "gapped":
            unused += K2_FORMULAS
        unused = [op for op in unused if op not in ops]
    return read_counts(label, *path_kernels(case, ops, impl,
                                            unused_ops=unused))


def facade_ches(dev, fc, timer) -> dict:
    """CHES, BGMW95 and CHES again through the facade on one point list:
    the first call (split), FACADE_SEEDS repeat calls against as many
    engine.msm_ches_device queries on the memo's plan (timed beside them,
    the same kernels and counts), the BGMW call upgrading the plan in place
    (the 3nh table's object kept) and a CHES call after it."""
    from msm_blst_tpu_torch.msm import engine, recode

    curve, case = fc.case.curve, fc.case
    name = curve.name
    ches, bgmw = fc.fn("_tile_pippenger_d_CHES"), fc.fn("_tile_pippenger_BGMW95")
    paths = {}
    first = FACADE_SEEDS[0]
    reset_counts()
    jac, total, parts = timer.call(lambda: ches(fc.points, fc.ints[first],
                                                device=dev))
    fc.check(f"{name} facade CHES first call", first, jac)
    print(f"{name} facade CHES first call: {split_line(total, parts)}")
    paths[f"{name}_facade_ches_first"] = facade_path(
        f"{name} facade CHES first call", case, ["point_double", "point_dadd"],
        "gapped", "prefix")
    plan = fc.api._ches_plan(curve, fc.points, device=dev)
    table = plan.table3nh
    reset_counts()
    times, host = [], []
    for s in FACADE_SEEDS:
        jac, total, parts = timer.call(lambda s=s: ches(fc.points, fc.ints[s],
                                                        device=dev))
        fc.check(f"{name} facade CHES", s, jac)
        times.append(total)
        host.append(sum(parts.get(k, 0.0) for k in
                        ("_points_digest", "_scalars_device", "_jac_ints")))
        print(f"{name} facade CHES repeat call, seed {s}: "
              f"{split_line(total, parts)}")
    facade = facade_counts()
    paths[f"{name}_facade_ches"] = facade_path(
        f"{name} facade CHES", case, [], "gapped", "prefix")
    check_ches_k2(f"{name} facade CHES", case, facade, len(FACADE_SEEDS))
    scalars = {s: recode.to_device(recode.scalars_from_ints(fc.ints[s]), dev)
               for s in FACADE_SEEDS}
    reset_counts()
    eng = []
    for s in FACADE_SEEDS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        jac = engine.msm_ches_device(plan, scalars[s])
        torch.cuda.synchronize()
        eng.append(time.perf_counter() - t)
        # the facade's own host conversion: no launch on the path
        fc.check(f"{name} facade engine query", s,
                 timer.saved["_jac_ints"](plan.curve, jac))
    engine_counts = facade_counts()
    paths[f"{name}_facade_engine_ches"] = facade_path(
        f"{name} facade engine query", case, [], "gapped", "prefix")
    if facade != engine_counts:
        raise AssertionError(f"{name} facade CHES launched {facade}, the "
                             f"engine's queries {engine_counts}")
    share = sum(host) / sum(times)
    print(f"{name} facade CHES: {len(times)} repeat calls equal to the "
          f"oracle, the same launches as {len(eng)} engine queries; call "
          f"mean {1e3 * sum(times) / len(times):.3f} ms, min "
          f"{1e3 * min(times):.3f} ms; engine query mean "
          f"{1e3 * sum(eng) / len(eng):.3f} ms, min {1e3 * min(eng):.3f} ms;"
          f" host share (digest, scalars, result) {100 * share:.1f}% "
          f"({1e3 * sum(host) / len(host):.3f} ms a call) on {card_line()}")
    s = FACADE_BGMW_SEED
    reset_counts()
    jac, total, parts = timer.call(lambda: bgmw(fc.points, fc.ints[s],
                                                device=dev))
    fc.check(f"{name} facade BGMW95", s, jac)
    plan = fc.api._ches_plan(curve, fc.points, device=dev)
    if plan.table3nh is not table or plan.table_nh is None:
        raise AssertionError(f"{name} facade BGMW95: the plan was not "
                             "upgraded in place")
    print(f"{name} facade BGMW95 (the plan upgraded in place, nh table "
          f"{tuple(plan.table_nh.XY.shape)}, the 3nh table's object kept): "
          f"{split_line(total, parts)}")
    paths[f"{name}_facade_bgmw_upgrade"] = facade_path(
        f"{name} facade BGMW95", case, [], "weighted", "prefix")
    reset_counts()
    jac, total, parts = timer.call(lambda: ches(fc.points, fc.ints[s],
                                                device=dev))
    fc.check(f"{name} facade CHES after BGMW95", s, jac)
    if "build_plan" in parts or fc.api._ches_plan(
            curve, fc.points, device=dev).table3nh is not table:
        raise AssertionError(f"{name} facade CHES after BGMW95 rebuilt")
    print(f"{name} facade CHES after BGMW95: {split_line(total, parts)}")
    paths[f"{name}_facade_ches_after_bgmw"] = facade_path(
        f"{name} facade CHES after BGMW95", case, [], "gapped", "prefix")
    return paths


def facade_c2(dev, fc, timer) -> dict:
    """The stale-plan hole of the JAX facade, closed: the point at
    FACADE_C2_POS, which the JAX digest's probes never read, becomes G in
    the same list object; the next CHES call must equal the new oracle."""
    name = fc.case.curve.name
    fc.replace(FACADE_C2_POS, 1)
    s = FACADE_SEEDS[0]
    reset_counts()
    jac, total, parts = timer.call(lambda: fc.fn("_tile_pippenger_d_CHES")(
        fc.points, fc.ints[s], device=dev))
    fc.check(f"{name} facade C2", s, jac)
    print(f"{name} facade C2: point {FACADE_C2_POS} replaced in place, the "
          f"next CHES call equals the new oracle (a plan of its own): "
          f"{split_line(total, parts)}")
    return facade_path(f"{name} facade C2", fc.case,
                       ["point_double", "point_dadd"], "gapped", "prefix")


def facade_off_table(dev, case, timer) -> dict:
    """One G1 CHES call at n = FACADE_OFF_N, off the config table: the
    nearest shipped radix (api._facade_config)."""
    fc = FacadeCase(case, FACADE_OFF_N, (WARM_SEED,), dev)
    cfg = fc.api._facade_config(FACADE_OFF_N)
    reset_counts()
    jac, total, parts = timer.call(lambda: fc.fn("_tile_pippenger_d_CHES")(
        fc.points, fc.ints[WARM_SEED], device=dev))
    fc.check("G1 facade off-table n", WARM_SEED, jac)
    print(f"G1 facade CHES at n = {FACADE_OFF_N} (c={cfg.c}, h={cfg.h}, "
          f"|B|={cfg.b_size}) equals the oracle: {split_line(total, parts)}")
    return facade_path("G1 facade off-table n", case,
                       ["point_double", "point_dadd"], "gapped", "prefix")


def facade_batch(dev, fc, timer) -> dict:
    """Stock Pippenger (at the default window, and the tile at
    FACADE_TILE_WINDOW), and on G1 p1s_add and p1s_to_affine with infinity
    lanes and wbits at FACADE_WBITS over 2^FACADE_WBITS_LOG points, each a
    path, each against the oracle."""
    from msm_blst_tpu_torch.constants import P

    api, case, curve = fc.api, fc.case, fc.case.curve
    name, s = curve.name, FACADE_SEEDS[1]
    paths = {}
    calls = [("stock", lambda: fc.fn("s_mult_pippenger")(
        fc.points, fc.ints[s], device=dev)),
             ("tile", lambda: fc.fn("s_tile_pippenger")(
                 fc.points, fc.ints[s], FACADE_TILE_WINDOW, device=dev))]
    for what, call in calls:
        reset_counts()
        jac, total, _ = timer.call(call)
        fc.check(f"{name} facade {what}", s, jac)
        print(f"{name} facade {what}: equals the oracle, {1e3 * total:.3f} "
              "ms")
        paths[f"{name}_facade_{what}"] = facade_path(
            f"{name} facade {what}", case, [], "weighted", "prefix")
    if name != "G1":
        return paths
    ref, r = fc.ref, fc.r
    e = [pow(2, i + 1, r) for i in range(fc.n)]  # P_i = e_i G
    e[FACADE_C2_POS] = 1  # facade_c2 made it G
    pts, e_inf = list(fc.points), list(e)
    for i in FACADE_INF_LANES:
        pts[i], e_inf[i] = (0, 0), 0
    reset_counts()
    jac, total, _ = timer.call(lambda: api.p1s_add(pts, device=dev))
    if api.p1_to_affine(jac) != ref.mult(sum(e_inf) % r):
        raise AssertionError("G1 facade p1s_add differs from the oracle")
    print(f"G1 facade p1s_add: {fc.n} points ({len(FACADE_INF_LANES)} at "
          f"infinity) equal to the oracle, {1e3 * total:.3f} ms")
    paths["G1_facade_add"] = facade_path("G1 facade p1s_add", case,
                                         ["point_dadd"])
    rng = np.random.default_rng(FACADE_SEEDS[2])
    zs = [int.from_bytes(rng.bytes(48), "little") % P for _ in pts]
    jacs = [(x * z * z % P, y * z * z * z % P, z)
            for (x, y), z in zip(pts, zs)]
    for i in FACADE_INF_LANES:
        jacs[i] = (1, 1, 0)
    reset_counts()
    got, total, _ = timer.call(lambda: api.p1s_to_affine(jacs, device=dev))
    if got != pts:
        raise AssertionError("G1 facade p1s_to_affine differs")
    print(f"G1 facade p1s_to_affine: {fc.n} Jacobian points ({len(FACADE_INF_LANES)}"
          f" at infinity, mapped to (0, 0)) equal to their affine points, "
          f"{1e3 * total:.3f} ms")
    paths["G1_facade_to_affine"] = facade_path("G1 facade p1s_to_affine",
                                               case, [])
    m = 1 << FACADE_WBITS_LOG
    reset_counts()
    table, total, _ = timer.call(lambda: api.p1s_mult_wbits_precompute(
        fc.points[:m], FACADE_WBITS, device=dev))
    print(f"G1 facade p1s_mult_wbits_precompute: {m} points, w = "
          f"{FACADE_WBITS}, table {tuple(table.X.shape)}, {1e3 * total:.3f}"
          " ms")
    paths["G1_facade_wbits_precompute"] = facade_path(
        "G1 facade wbits precompute", case, ["point_dadd_affine"])
    ks = fc.ints[s][:m]
    want = ref.mult(sum(k * w for k, w in zip(ks, e[:m])) % r)
    reset_counts()
    jac, total, _ = timer.call(lambda: api.p1s_mult_wbits(
        table, ks, FACADE_WBITS, device=dev))
    if api.p1_to_affine(jac) != want:
        raise AssertionError("G1 facade p1s_mult_wbits differs from the "
                             "oracle")
    print(f"G1 facade p1s_mult_wbits: equals the oracle, {1e3 * total:.3f} ms")
    paths["G1_facade_wbits"] = facade_path("G1 facade wbits", case,
                                           ["point_double", "point_dadd"])
    return paths


def facade_native(fc) -> None:
    """p1_construct_nh_scalars_nh_points at n = 2^16 (the native
    conversion) timed whole, and its recode (recode.ches_recode_host)
    timed alone beside the numpy twin's on the same scalar words; the
    same words from both."""
    from msm_blst_tpu_torch.constants import R_ORDER
    from msm_blst_tpu_torch.msm import params, recode

    ints = fc.ints[FACADE_SEEDS[0]]
    cfg = params.CONFIGS.get(N_LOG) or params.make_config(N_LOG, c=13, h=20)
    sc = recode.scalars_from_ints([k % R_ORDER for k in ints])
    times = {"facade call": [], "native recode": [], "numpy twin": []}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name].append(time.perf_counter() - t)
        return out

    for _ in range(3):
        b, s, slots = timed("facade call", lambda: fc.api.
                            p1_construct_nh_scalars_nh_points(ints, cfg))
        got = timed("native recode", lambda: recode.ches_recode_host(
            sc, cfg.c, cfg.h, cfg.ah))
        want = timed("numpy twin", lambda: recode.ches_recode_host(
            sc, cfg.c, cfg.h, cfg.ah, use_native=False))
    tb, tm, ts = want
    i_idx = np.arange(fc.n, dtype=np.int64)[:, None]
    j_idx = np.arange(cfg.h, dtype=np.int64)[None, :]
    t_slots = (3 * (i_idx * cfg.h + j_idx) + (tm - 1)).astype(np.int32)
    if not (all(np.array_equal(g, w) for g, w in zip(got, want))
            and np.array_equal(b, tb) and np.array_equal(s, ts)
            and np.array_equal(slots, t_slots)):
        raise AssertionError("facade native conversion differs from the "
                             "numpy twin")
    print(f"G1 facade p1_construct_nh_scalars_nh_points at 2^{N_LOG}, the "
          "same words native and numpy; ms min (each of 3): " + "; ".join(
              f"{k} {1e3 * min(v):.3f} ({', '.join(f'{1e3 * t:.3f}' for t in v)})"
              for k, v in times.items()))


def phase_facade(dev, g1, g2):
    """The blst-named facade on the card: CHES (first call split, repeat
    calls against the engine's query, the in-place BGMW upgrade, CHES
    again) on G1 and G2 at 2^16, the stale-plan case (FACADE_C2_POS) and an
    off-table n on G1, stock and tile (G1, G2), p1s_add, p1s_to_affine and
    wbits (G1), and the native scalar conversion. Every result against the
    oracle; each call group a path. Clears the plan memo and the
    allocator's cache after. Returns the launch counts by path."""
    t0 = time.perf_counter()
    print(f"facade phase on {card_line()}")
    timer = FacadeTimer()
    paths = {}
    n = 1 << N_LOG
    seeds = FACADE_SEEDS + (FACADE_BGMW_SEED,)
    for case in (g1, g2):
        fc = FacadeCase(case, n, seeds, dev)
        paths.update(facade_ches(dev, fc, timer))
        if case is g1:
            paths["G1_facade_c2"] = facade_c2(dev, fc, timer)
            facade_native(fc)
        paths.update(facade_batch(dev, fc, timer))
        del fc
        timer.api._PLAN_CACHE.clear()
        torch.cuda.empty_cache()
    paths["G1_facade_off_table"] = facade_off_table(dev, g1, timer)
    timer.restore()
    timer.api._PLAN_CACHE.clear()
    torch.cuda.empty_cache()
    print(f"facade phase: {time.perf_counter() - t0:.3f} s")
    return paths


# The big-n phase: CONFIGS[21] (c = 22, h = 12, |B| = 874,437; BGMW aliased
# into the 3nh table) on G1 and G2, CONFIGS[20]'s BGMW table (c' = 20,
# h' = 13, not aliased) on G1, and the plan cache at n = 2^16
BIGN_LOG = 21
NH_LOG = 20
BIGN_SEEDS = (2, 3)  # timed scalar sets of each G1 2^21 query
G2_BIGN_SEEDS = (2,)  # and of the G2 and the 2^20 queries
BIGN_CHUNKS = 4  # the fixed chunk count each msm_bign query also runs at
GIB = float(1 << 30)


def bign_scalars(n: int, seed: int) -> np.ndarray:
    """uint32[8, n] scalars below r from a numpy seed, made in bulk (eight
    random words, the top one below r's); lanes 0 and 1 are 0 and r - 1."""
    from msm_blst_tpu_torch.constants import R_ORDER
    from msm_blst_tpu_torch.msm import recode

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    w[7] %= np.uint32(R_ORDER >> 224)
    w[:, :2] = recode.scalars_from_ints([0, R_ORDER - 1])
    return w


def weighted_total(sc: np.ndarray) -> int:
    """sum_i s_i 2^(i+1) mod r of uint32[8, n] scalars, fast at any n: bit
    b of word k of every scalar, read as one n-bit integer, shifted into
    place (32 k + b)."""
    from msm_blst_tpu_torch.constants import R_ORDER

    n = sc.shape[1]
    total = 0
    for k in range(8):
        bits = np.unpackbits(np.ascontiguousarray(sc[k]).view(np.uint8)
                             .reshape(n, 4), axis=1, bitorder="little")
        cols = np.packbits(bits.T, axis=1, bitorder="little")
        for b in range(32):
            total += int.from_bytes(cols[b].tobytes(), "little") << (32 * k + b)
    return 2 * total % R_ORDER


class BignCase:
    """One curve's big-n scalar sets on the card and their oracle points
    ((sum s_i 2^(i+1) mod r) * G), by seed."""

    def __init__(self, case, n: int, seeds, dev):
        from msm_blst_tpu_torch import refimpl
        from msm_blst_tpu_torch.msm import recode

        ref = refimpl.CURVES[case.curve.name]
        self.case, self.n = case, n
        host = {s: bign_scalars(n, s) for s in seeds}
        self.scalars = {s: recode.to_device(a, dev) for s, a in host.items()}
        self.want = {s: ref.mult(weighted_total(a)) for s, a in host.items()}

    def check(self, label, seed, jac, curve):
        if curve.affine_to_ints(curve.jac_to_affine(jac))[0] != self.want[seed]:
            raise AssertionError(f"{label} seed {seed}: MSM differs from the "
                                 "oracle")


def bign_plan(label, bc, cfg, dev, **tables):
    """Fixed points and a streamed plan of `tables` (build_plan's ches,
    bgmw), timed, with the build's peak device memory and launches."""
    from msm_blst_tpu_torch.msm import build_plan, fixed_point_list

    case = bc.case
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    points = fixed_point_list(case.curve, bc.n, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plan = build_plan(case.curve, points, cfg, stock=False, streamed=True,
                      **tables)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    shapes = {name: tuple(t.XY.shape) for name, t in
              (("3nh", plan.table3nh), ("nh", plan.table_nh)) if t is not None}
    nbytes = sum(4 * s[0] * s[1] for s in shapes.values())
    print(f"{label}: n=2^{bc.n.bit_length() - 1}, c={cfg.c}, h={cfg.h}, "
          f"c'={cfg.c_bgmw}, h'={cfg.h_bgmw}, |B|={cfg.b_size}, layout "
          f"{plan.layout}, bgmw_stride3 {plan.bgmw_stride3}, tables {shapes} "
          f"({nbytes / GIB:.3f} GiB); fixed points {t1 - t0:.3f} s, tables "
          f"{t2 - t1:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / GIB:.3f} GiB")
    ops = ["point_dadd_affine", "point_double"] + (
        ["point_dadd"] if plan.table3nh is not None else [])
    launches = read_counts(f"{label} build", *path_kernels(case, ops))
    return plan, launches


def bign_query(label, bc, plan, query, seeds, integration):
    """One warm-up and the timed scalar sets `seeds` of `query(scalars)`,
    each checked against the oracle; prints the mean and min ms, the peak
    device memory and the chunks a query; every K3 launch at stream_shape
    of its chunk's stream. Returns the path's launches."""
    from msm_blst_tpu_torch.msm import prefix_pipeline

    case = bc.case
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    bc.check(label, WARM_SEED, query(bc.scalars[WARM_SEED]), plan.curve)
    times = []
    for s in seeds:
        torch.cuda.synchronize()
        t = time.perf_counter()
        jac = query(bc.scalars[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        bc.check(label, s, jac, plan.curve)
    peak = torch.cuda.max_memory_allocated() / GIB
    queries = 1 + len(seeds)
    want = [prefix_pipeline.stream_shape(N) for N in STREAMS if N]
    print(f"{label}: {len(seeds)} queries equal to the oracle; query mean "
          f"{1e3 * sum(times) / len(times):.3f} ms, min {1e3 * min(times):.3f}"
          f" ms; peak device memory {peak:.3f} GiB; "
          f"{len(STREAMS) / queries:g} chunks a query, streams of "
          f"{min(STREAMS)}-{max(STREAMS)} digits; K3 shapes "
          f"{sorted(set(LEVEL_CALLS))}")
    if LEVEL_CALLS != want:
        raise AssertionError(f"{label}: K3 ran at {LEVEL_CALLS}, not at its "
                             f"chunks' stream_shape {want}")
    launches = read_counts(label, *path_kernels(
        case, query_kernels(integration, "prefix"), "prefix"))
    per_query(label, case, launches, queries)
    return launches


def level_steps_plain(curve, rx, ry, sg, local):
    """K3's local prefixes of some lanes, step by step by the plain
    version: column 0 the lifted signed point, each column j the plain
    mixed add of column j - 1's prefix (K3's own) and point j, all columns
    in one batched call. Returns (K3's prefixes, the plain ones), xyzz
    batches over (column, lane); equal words at every step mean K3's
    lanes equal the plain level's."""
    from msm_blst_tpu_torch.curves import AffinePoint, XyzzPoint, cuda_point

    W = curve.F.n_words

    def words(rows, k):  # (c, L, k W) rows -> k coordinates of (*lead, c L)
        flat = rows.reshape(-1, k * W)
        return [curve.from_words(flat[:, i * W:(i + 1) * W].T.contiguous())
                for i in range(k)]

    got = XyzzPoint(*words(local, 4))
    X, Y = words(rx, 1)[0], words(ry, 1)[0]
    sub = sg.reshape(-1) != 0
    L = rx.shape[1]
    first = curve.xyzz_from_affine(AffinePoint(X[..., :L], Y[..., :L]),
                                   negate=sub[:L])
    steps = cuda_point.xyzz_dadd_affine_plain(
        curve, XyzzPoint(*(x[..., :-L] for x in got)),
        AffinePoint(X[..., L:], Y[..., L:]), sub[L:])
    want = XyzzPoint(*(torch.cat([f, t], dim=-1) for f, t in zip(first, steps)))
    return got, want


def bign_kernels(case, plan, tag):
    """K3 at the level shape of the plan's whole CHES stream (n h digits)
    on rows of its table drawn with a seed, its first and last 128 lanes
    checked step by step against the plain version (level_steps_plain: the
    plain level alone runs its c adds one call at a time, half a minute
    here), then K4 over the level's lane tails and, G1, over CONFIGS[21]'s
    |B| - 1 suffix sums, each against its plain version; recorded under
    "<kernel> <tag>"."""
    from msm_blst_tpu_torch.curves import XyzzPoint
    from msm_blst_tpu_torch.msm import cuda_scan, prefix_pipeline, scan
    from msm_blst_tpu_torch.utils.profiling import device_ms

    curve, E = case.curve, case.elem_bytes
    W = curve.F.n_words
    dev = plan.table3nh.XY.device
    cfg = plan.cfg
    c, n_ch = prefix_pipeline.stream_shape(plan.points.X.shape[-1] * cfg.h)
    rows = plan.table3nh.XY
    gen = torch.Generator(device=dev).manual_seed(13)
    slots = torch.randint(0, rows.shape[0], (c * n_ch,), device=dev,
                          generator=gen)
    g = rows.index_select(0, slots)
    del slots
    rx = g[:, :W].reshape(c, n_ch, W).contiguous()
    ry = g[:, W:].reshape(c, n_ch, W).contiguous()
    del g
    sg = torch.randint(0, 2, (c, n_ch), device=dev, dtype=torch.int32,
                       generator=gen)
    local, tails = cuda_scan.affine_prefix_level(curve, rx, ry, sg)
    lanes = torch.cat([torch.arange(128, device=dev),
                       torch.arange(n_ch - 128, n_ch, device=dev)])
    got, want = level_steps_plain(curve, rx[:, lanes], ry[:, lanes],
                                  sg[:, lanes], local[:, lanes])
    last = XyzzPoint(*(x[..., -len(lanes):] for x in got))
    err = max(max_abs_err(got, want),
              max_abs_err(last, tuple(t[..., lanes] for t in tails)))
    name = case.name("affine_prefix_level")
    ms = device_ms(lambda: cuda_scan.affine_prefix_level(curve, rx, ry, sg), 3)
    b = bound(c * n_ch * (6 * E + 4) + 4 * E * n_ch,
              case.mont(DADD_AFFINE) * (c - 1) * n_ch)
    RESULTS[f"{name} {tag}"] = {
        "c": c, "n_ch": n_ch, "max_abs_err": err, "checked_lanes": len(lanes),
        "ms": ms, "plain_ms": None, **b, "library_ms": None}
    print(f"kernel {name} {tag} (c, n_ch)=({c}, {n_ch}): max_abs_err {err} "
          f"on {len(lanes)} lanes, step by step; {ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); depth {c} + "
          f"{scan.scan_depth(scan.scan_schedule(n_ch))} adds (K4 over the "
          "tails)")
    if err != 0:
        raise AssertionError(f"{name} {tag}: kernel and plain version differ")
    del rx, ry, sg, got, want, last
    lengths = [n_ch] + ([cfg.b_size - 1] if curve.name == "G1" else [])
    pts = XyzzPoint(*(curve.from_words(local.reshape(-1, 4, W)[:max(lengths), i]
                                       .T) for i in range(4)))
    del local
    name = case.name("xyzz_prefix_scan")
    for N in lengths:
        head = XyzzPoint(*(x[..., :N].contiguous() for x in pts))
        r = record(f"{name} {tag} {N}",
                   lambda: tuple(scan.prefix_scan_xyzz(curve, head)),
                   lambda: tuple(scan.prefix_scan_xyzz_plain(curve, head)),
                   5, 1, 8 * E * N, case.mont(DADD) * (N - 1))
        r["N"] = N
    torch.cuda.empty_cache()


def inversion_kernels(plan_launches, n: int):
    """K1 at the commonest batch of more than one element the big-n plan
    build launched it at (the chunked product scans of a window's batch
    inversion) and at a window's whole 3n-lane batch, against its plain
    version."""
    from msm_blst_tpu_torch.fields import cuda_mont
    from msm_blst_tpu_torch.fields.limb import FP

    B = next(size for size, _ in plan_launches.most_common() if size > 1)
    for lanes in (B, 3 * n):
        a = _random_fp(lanes, 21, torch.device("cuda"))
        b = _random_fp(lanes, 22, torch.device("cuda")).flip(1).contiguous()
        record(f"mont_mul bign {lanes}", lambda: cuda_mont.mont_mul(a, b, FP),
               lambda: cuda_mont.mont_mul_plain(a, b, FP), 20, 1,
               3 * FP_BYTES * lanes, lanes)


def phase_bign(dev, g1, g2):
    """Big n: streamed plans ("j" layout) and msm_bign at CONFIGS[21] on G1
    (CHES device, msm_bign CHES and BGMW at their own chunk count and at
    BIGN_CHUNKS, the noindexhash CHES device query) and G2 (msm_bign CHES and BGMW), a BGMW-only plan of
    CONFIGS[20] (its own nh table) and the plan cache at 2^16. Returns the
    launch counts by path."""
    import dataclasses

    from msm_blst_tpu_torch.msm import msm_bign, msm_ches_device, params

    paths = {}
    cfg = params.CONFIGS[BIGN_LOG]
    n = 1 << BIGN_LOG
    for case, seeds in ((g1, BIGN_SEEDS), (g2, G2_BIGN_SEEDS)):
        name = case.curve.name
        bc = BignCase(case, n, (WARM_SEED,) + seeds, dev)
        label = f"{name} bign 2^{BIGN_LOG}"
        key = f"{name}_2^{BIGN_LOG}"  # the paths' names in the JSON line
        plan, paths[f"{key}_plan"] = bign_plan(label, bc, cfg, dev)
        batches = counters()["mont_mul"].batches.copy()
        queries = [("bign_ches", "gapped", lambda s: msm_bign(plan, s, "ches")),
                   ("bign_bgmw", "weighted",
                    lambda s: msm_bign(plan, s, "bgmw"))]
        if name == "G1":
            nih = dataclasses.replace(plan, noindexhash=True)
            queries = [("ches_device", "gapped",
                        lambda s: msm_ches_device(plan, s))] + queries + [
                ("bign_ches_4", "gapped",
                 lambda s: msm_bign(plan, s, "ches", BIGN_CHUNKS)),
                ("bign_bgmw_4", "weighted",
                 lambda s: msm_bign(plan, s, "bgmw", BIGN_CHUNKS)),
                ("ches_device_noindexhash", "gapped",
                 lambda s: msm_ches_device(nih, s))]
        for qname, integration, query in queries:
            paths[f"{key}_{qname}"] = bign_query(
                f"{label} {qname}", bc, plan, query, seeds, integration)
        bign_kernels(case, plan, f"2^{BIGN_LOG}")
        if name == "G1":
            inversion_kernels(batches, n)
            del nih
        del plan, bc
        torch.cuda.empty_cache()
    # CONFIGS[20]: c' = 20 differs from c = 22, so BGMW has its nh table
    cfg = params.CONFIGS[NH_LOG]
    bc = BignCase(g1, 1 << NH_LOG, (WARM_SEED,) + G2_BIGN_SEEDS, dev)
    label = f"G1 bign 2^{NH_LOG} nh"
    plan, paths[f"G1_2^{NH_LOG}_nh_plan"] = bign_plan(label, bc, cfg, dev,
                                                      ches=False)
    if plan.bgmw_stride3 or plan.table_nh is None:
        raise AssertionError(f"{label}: the plan holds no nh table")
    paths[f"G1_2^{NH_LOG}_bign_bgmw"] = bign_query(
        f"{label} bign_bgmw", bc, plan, lambda s: msm_bign(plan, s, "bgmw"),
        G2_BIGN_SEEDS, "weighted")
    del plan, bc
    torch.cuda.empty_cache()
    paths[f"G1_cache_2^{N_LOG}"] = phase_cache(dev, g1)
    return paths


def phase_cache(dev, case):
    """The CONFIGS[16] plan of CHES and BGMW (the "i" layout, its own nh
    table) saved to a temporary directory and loaded back: the tables
    equal word for word, the flags and the layout survive, and a CHES and
    a BGMW query from the loaded plan equal the oracle."""
    import tempfile

    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        load_plan, msm_bgmw_device,
                                        msm_ches_device, params, save_plan)

    curve = case.curve
    cfg = params.CONFIGS[N_LOG]
    n = 1 << N_LOG
    bc = BignCase(case, n, (WARM_SEED,), dev)
    plan = build_plan(curve, fixed_point_list(curve, n, device=dev), cfg,
                      stock=False)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        base = save_plan(plan, d)
        t1 = time.perf_counter()
        reset_counts()
        loaded = load_plan(curve, cfg, n, d, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    for name in ("table3nh", "table_nh"):
        if not torch.equal(getattr(plan, name).XY, getattr(loaded, name).XY):
            raise AssertionError(f"cache: {name} differs after the round trip")
    if (loaded.layout, loaded.bgmw_stride3) != (plan.layout, plan.bgmw_stride3):
        raise AssertionError("cache: the layout or the alias flag changed")
    label = f"{curve.name} cache 2^{N_LOG}"
    print(f"{label}: saved in {t1 - t0:.3f} s, loaded in {t2 - t1:.3f} s "
          f"({base.rsplit('/', 1)[-1]})")
    for query in (msm_ches_device, msm_bgmw_device):
        bc.check(f"{label} {query.__name__}", WARM_SEED,
                 query(loaded, bc.scalars[WARM_SEED]), loaded.curve)
    print(f"{label}: CHES and BGMW queries of the loaded plan equal the "
          "oracle")
    return read_counts(label, *path_kernels(
        case, query_kernels("gapped", "prefix")
        + query_kernels("weighted", "prefix"), "prefix"))


def phase_drivers(dev):
    """The three drivers at the JAX drivers' shapes, each printing its JSON
    lines, each counting its launches on its own. The microbench's K7 and
    int8 matmul rates become the measured anchors of the bounds."""
    from msm_blst_tpu_torch.drivers import gather_bench, microbench, mxu_experiment

    paths = {}
    reset_counts()
    recs = microbench.run(device=dev)
    paths["driver_microbench"] = read_counts(
        "driver microbench", [f"madd_chain_{d}" for d in microbench.DTYPES]
        + ["mont_mul", "sos_mul", "point_dadd_affine"])
    rate = {r["metric"]: r["value"] for r in recs}
    MEASURED.update(imad=rate["madd_chain_uint32_ops_per_s"] / 2,
                    ffma=rate["madd_chain_float32_ops_per_s"] / 2,
                    int8_mac=rate["matmul_int8_to_int32_macs_per_s"])
    print(f"measured: {MEASURED}; published peaks at the top SM clock: "
          f"IMAD {SMS * IMAD_PER_CLOCK * top_sm_mhz() * 1e6:.4g}/s, FFMA "
          f"{SMS * FFMA_PER_CLOCK * top_sm_mhz() * 1e6:.4g}/s, int8 MAC "
          f"{INT8_MAC_PER_S:.4g}/s")
    reset_counts()
    mxu_experiment.run(device=dev)
    paths["driver_mxu_experiment"] = read_counts(
        "driver mxu_experiment", ["mont_mul", "sos_mul", "sos_mul_prod",
                                  "sos_mul_bytes", "sos_mul_mm1"])
    reset_counts()
    gather_bench.run(device=dev)
    paths["driver_gather_bench"] = read_counts("driver gather_bench",
                                               ["gather_smem"])
    return paths


# ---------------------------------------------------------------------------
# phase 12: sharded (parallel/sharded.py on torch.distributed)
# ---------------------------------------------------------------------------

SHARD_RANKS = 4
SHARD_TIMEOUT_S = 600  # a rank that fails or hangs fails the run
SHARD_REPS = 2  # stage-timed runs of each path on each rank
SHARD_SEED = 2  # the scalar set of the counted query (WARM_SEED: warm-up)
# The plans of the sharded paths, each built once a rank, in turns, and
# sharded for its paths: (curve, log n, layout, paths), a path (name, mesh,
# query). G1 plans hold the CHES and BGMW tables: at CONFIGS[16] BGMW has
# its own nh table (c' = 17, h' = 15: the r - a fold), at CONFIGS[21] it
# reads the 3nh table's m = 1 rows (c' = c = 22, h = 12); G2's, CHES only.
SHARD_PLANS = (
    ("G1", 16, "i", (("points_ches", "points", "ches"),
                     ("points_bgmw", "points", "bgmw"),
                     ("mesh2d_ches", "2d", "ches_2d"))),
    ("G1", 16, "j", (("windows_ches", "windows", "ches_windows"),
                     ("windows_bgmw", "windows", "bgmw_windows"))),
    ("G2", 16, "i", (("points_ches", "points", "ches"),)),
    ("G1", 21, "j", (("windows_ches", "windows", "ches_windows"),
                     ("windows_bgmw", "windows", "bgmw_windows"))),
)
SHARD_QUERIES = {  # query -> (function's name, its integration)
    "ches": ("sharded_msm_ches", "gapped"),
    "bgmw": ("sharded_msm_bgmw", "weighted"),
    "ches_2d": ("sharded_msm_ches_2d", "gapped"),
    "ches_windows": ("sharded_msm_ches_windows", "gapped"),
    "bgmw_windows": ("sharded_msm_bgmw_windows", "weighted"),
}
BUTTERFLY_WIDTHS = {"G1": (109_244, 874_437), "G2": (109_244,)}


def shard_scalars(n: int, seed: int) -> np.ndarray:
    """bign_scalars (lanes 0 and 1: 0 and r - 1), then lane 2 = 1, lanes 3
    and 4 equal, lane 5 = r, lane 6 = r + 5, lane 7 = 2^255 - 1 (the
    recodes' domain ends at 2^255)."""
    from msm_blst_tpu_torch.constants import R_ORDER
    from msm_blst_tpu_torch.msm import recode

    sc = bign_scalars(n, seed)
    sc[:, 4] = sc[:, 3]
    sc[:, [2, 5, 6, 7]] = recode.scalars_from_ints(
        [1, R_ORDER, R_ORDER + 5, (1 << 255) - 1])
    return sc


def counts_of(fn):
    """(fn(), the launches it made by kernel name), the card's queue
    finished before and after."""
    torch.cuda.synchronize()
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in counters().items()}


def shard_path(rank, q, local, sets, want, label):
    """One sharded path on this rank: a warm-up and a counted query, each
    against the oracle; each stage's launches apart; the stages timed
    (ShardedQuery.stage_ms) and the peak memory."""
    torch.cuda.reset_peak_memory_stats()

    def check(seed, jac):
        got = q.curve.affine_to_ints(q.curve.jac_to_affine(jac))[0]
        if got != want[seed]:
            raise AssertionError(f"{label} rank {rank} seed {seed}: differs "
                                 "from the oracle")
    check(WARM_SEED, q(sets[WARM_SEED]))
    sc = sets[SHARD_SEED]
    jac, launches = counts_of(lambda: q(sc))
    check(SHARD_SEED, jac)
    buckets, local_l = counts_of(lambda: q.local(sc))
    reduced, reduce_l = counts_of(lambda: q.allreduce(buckets))
    _, integrate_l = counts_of(lambda: q.integrate(reduced))
    tables = [t.XY for t in (local.table3nh, local.table_nh) if t is not None]
    return {"rows": sum(t.shape[0] for t in tables),
            "bytes": sum(t.numel() * 4 for t in tables),
            "buckets": buckets.X.shape[-1], "launches": launches,
            "stages": (local_l, reduce_l, integrate_l),
            **q.stage_ms(sc, SHARD_REPS),
            "peak_gib": torch.cuda.max_memory_allocated() / GIB}


def shard_edges(rank, plan, sc, mesh):
    """The edge cases on this rank: a 3-rank subgroup refused ("power of
    two") on its members; on rank 0, a one-rank NCCL group's query
    against engine.msm_ches_device on the same plan (its communicator
    started by an all-reduce); a "j" plan refused by the points-axis
    functions."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from msm_blst_tpu_torch.msm import msm_ches_device
    from msm_blst_tpu_torch.parallel import sharded as S

    out = {}
    curve, dev = plan.curve, sc.device
    three = dist.new_group([0, 1, 2])
    nccl = dist.new_group([0], backend="nccl")
    if rank < 3:
        try:
            S.ec_allreduce_xyzz(curve, curve.xyzz_inf((8,), dev), three)
        except ValueError as e:
            out["three_ranks"] = str(e)
        if "power of two" not in out.get("three_ranks", ""):
            raise AssertionError(f"rank {rank}: a 3-rank group was not "
                                 "refused")
    if rank == 0:
        one = torch.ones(1, device=dev)
        dist.all_reduce(one, group=nccl)
        mesh1 = DeviceMesh.from_group(nccl, "cuda", mesh_dim_names=("points",))
        q = S.sharded_msm_ches(S.shard_plan_tables(plan, mesh1), mesh1)
        got = curve.affine_to_ints(curve.jac_to_affine(q(sc)))[0]
        want = curve.affine_to_ints(curve.jac_to_affine(
            msm_ches_device(plan, sc)))[0]
        if got != want or q.rounds() != 0 or float(one) != 1.0:
            raise AssertionError("a one-rank NCCL group differs from "
                                 "msm_ches_device")
        out["nccl_one_rank"] = (f"{dist.get_backend(nccl)} group of "
                                f"{dist.get_world_size(nccl)}, 0 rounds, "
                                "equal to msm_ches_device")
    j_plan = dataclasses.replace(plan, layout="j")
    for fn in (S.shard_plan_tables, S.sharded_msm_ches, S.sharded_msm_bgmw):
        try:
            fn(j_plan, mesh)
        except ValueError as e:
            if "i-major" not in str(e):
                raise
        else:
            raise AssertionError(f"{fn.__name__} took a 'j' plan")
    out["j_refused"] = "shard_plan_tables, sharded_msm_ches, sharded_msm_bgmw"
    return out


def sharded_rank(rank: int, world: int, dev) -> dict:
    """One rank of the sharded phase (a spawned process on `dev`, which
    run_ranks chose: on one card, every rank shares it in a gloo group): each plan of SHARD_PLANS built in turns with the
    other ranks and sharded for its paths (the full plan dropped, but for
    the edge cases' CONFIGS[16] "i" plan), each path's readings, then the
    edge cases."""
    from msm_blst_tpu_torch import kernels, refimpl
    from msm_blst_tpu_torch.curves import G1, G2
    from msm_blst_tpu_torch.msm import build_plan, fixed_point_list, params
    from msm_blst_tpu_torch.msm import recode
    from msm_blst_tpu_torch.parallel import sharded as S
    from msm_blst_tpu_torch.parallel.ranks import in_turns

    kernels.load()  # the parent's build: nothing compiles here
    meshes = {"points": S.make_points_mesh(world),
              "windows": S.make_windows_mesh(world),
              "2d": S.make_2d_mesh(2, world // 2)}
    out = {"paths": {}}
    for i, (cname, log_n, layout, paths) in enumerate(SHARD_PLANS):
        curve = {"G1": G1, "G2": G2}[cname]
        n = 1 << log_n
        host = {s: shard_scalars(n, s) for s in (WARM_SEED, SHARD_SEED)}
        sets = {s: recode.to_device(a, dev) for s, a in host.items()}
        ref = refimpl.CURVES[cname]
        want = {s: ref.mult(weighted_total(a)) for s, a in host.items()}
        keep = i == 0  # the edge cases run on the first plan's

        def build():
            t0 = time.perf_counter()
            full = build_plan(curve, fixed_point_list(curve, n, device=dev),
                              params.CONFIGS[log_n], stock=False,
                              bgmw=cname == "G1", streamed=layout == "j")
            locs = {m: (S.shard_plan_tables_jmajor if m == "windows"
                        else S.shard_plan_tables)(full, meshes[m])
                    for m in {m for _, m, _ in paths}}
            torch.cuda.synchronize()
            return (full if keep else None), locs, time.perf_counter() - t0

        # one rank after another: four "i" builds of the G2 2^16 plan at
        # once exhausted the card's memory, and each rank sees the others'
        # memory in mem_get_info, which sizes a streamed build
        full, locs, build_s = in_turns(rank, world, dev, build)
        for name, m, kind in paths:
            label = f"{cname}_sharded_{name}_2^{log_n}"
            fn = getattr(S, SHARD_QUERIES[kind][0])
            out["paths"][label] = {"build_s": build_s, "query": kind,
                                   **shard_path(
                rank, fn(locs[m], meshes[m]), locs[m], sets, want,
                label)}
        if keep:
            out["edges"] = shard_edges(rank, full, sets[SHARD_SEED],
                                       meshes["points"])
        del full, locs, sets
        torch.cuda.empty_cache()
    return out


def butterfly_kernels(dev, case):
    """K2 dadd at the butterfly's widths (the CHES bucket arrays of
    CONFIGS[16] and, G1, CONFIGS[21]) against its plain version, on the
    lanes k2_lanes makes of the 2^16 fixed points, repeated to the width."""
    from msm_blst_tpu_torch.curves import XyzzPoint, cuda_point
    from msm_blst_tpu_torch.msm import fixed_point_list

    curve, E = case.curve, case.elem_bytes
    acc, other, _ = k2_lanes(curve, fixed_point_list(curve, 1 << N_LOG,
                                                     device=dev))
    for B in BUTTERFLY_WIDTHS[curve.name]:
        k = -(-B // (1 << N_LOG))

        def wide(p):
            return XyzzPoint(*(torch.cat([x] * k, dim=-1)[..., :B]
                               .contiguous() for x in p))
        a, b = wide(acc), wide(other)
        record(f"{case.name('point_dadd')} butterfly {B}",
               lambda: tuple(cuda_point.xyzz_dadd(curve, a, b)),
               lambda: tuple(cuda_point.xyzz_dadd_plain(curve, a, b)), 10, 1,
               12 * E * B, case.mont(DADD) * B)
        del a, b
    torch.cuda.empty_cache()


def check_sharded_path(label, case, integration, rows) -> dict:
    """A sharded path's launches, from each rank's readings: each rank's
    query launched its three stages' kernels and nothing else, the
    all-reduce K2 dadd once a round and nothing else; a CHES query no
    other dadd; together the kernels of its single-card query. Returns
    the launches summed over the ranks."""
    dadd = case.name("point_dadd")
    rounds = rows[0]["rounds"]
    for rank, r in enumerate(rows):
        local_l, reduce_l, integrate_l = r["stages"]
        whole = {k: local_l[k] + reduce_l[k] + integrate_l[k]
                 for k in local_l}
        if whole != r["launches"]:
            raise AssertionError(f"{label} rank {rank}: the stages launched "
                                 f"{whole}, the query {r['launches']}")
        stray = {k: v for k, v in reduce_l.items() if v and k != dadd}
        if reduce_l[dadd] != rounds or stray:
            raise AssertionError(f"{label} rank {rank}: the all-reduce "
                                 f"launched {dadd} {reduce_l[dadd]} times "
                                 f"over {rounds} rounds, and {stray}")
        if integration == "gapped" and r["launches"][dadd] != rounds:
            raise AssertionError(f"{label} rank {rank}: {dadd} launched "
                                 f"{r['launches'][dadd]} times, not {rounds}")
    total = {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}
    return check_path(label, total, *path_kernels(
        case, query_kernels(integration, "prefix") + ["point_dadd"],
        "prefix"))


def phase_sharded(dev, g1, g2):
    """The sharded paths (parallel/sharded.py) on SHARD_RANKS spawned ranks
    (on one card, a gloo group sharing it): K2 dadd at the butterfly's widths
    first, then each rank's readings by path (sharded_rank), every result
    against the oracle on every rank, the launches checked
    (check_sharded_path), and the edge cases. Returns the launches by
    path, summed over the ranks."""
    from msm_blst_tpu_torch.parallel import run_ranks
    from msm_blst_tpu_torch.parallel.ranks import group_backend

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"sharded: the card's free memory {free / GIB:.3f} of "
          f"{total / GIB:.3f} GiB; this process holds "
          f"{torch.cuda.memory_allocated(dev) / GIB:.3f} GiB allocated")
    for case in (g1, g2):
        butterfly_kernels(dev, case)
    cards = min(SHARD_RANKS, torch.cuda.device_count())
    where = (f"{SHARD_RANKS} ranks sharing one {card_line()}" if cards == 1
             else f"{SHARD_RANKS} ranks on {cards} cards, {card_line()}")
    where += f", {group_backend('cuda', SHARD_RANKS)} group"
    per_rank = run_ranks(sharded_rank, SHARD_RANKS, dev,
                         timeout_s=SHARD_TIMEOUT_S)
    paths = {}
    for label in per_rank[0]["paths"]:
        rows = [r["paths"][label] for r in per_rank]
        kind = rows[0]["query"]
        case = g1 if label.startswith("G1") else g2
        for rank, r in enumerate(rows):
            print(f"{label} rank {rank} ({where}): equal to the oracle "
                  f"(2 sets); shard build {r['build_s']:.3f} s, {r['rows']} "
                  f"rows ({r['bytes'] / GIB:.3f} GiB), {r['buckets']} "
                  f"buckets; local {r['local_ms']:.3f} ms, all-reduce "
                  f"{r['allreduce_ms']:.3f} ms (exchange "
                  f"{r['exchange_ms']:.3f} + K2 dadd {r['dadd_ms']:.3f}, "
                  f"{r['rounds']} rounds), integration "
                  f"{r['integrate_ms']:.3f} ms, total {r['total_ms']:.3f} ms;"
                  f" peak {r['peak_gib']:.3f} GiB")
        paths[label] = check_sharded_path(label, case,
                                          SHARD_QUERIES[kind][1], rows)
    for rank, r in enumerate(per_rank):
        print(f"sharded edges rank {rank}: {r['edges']}")
    print(f"sharded phase: {time.perf_counter() - t0:.1f} s ({where})")
    return paths


# The TPU kernel each kernel replaces, by name or by op (the point formulas
# share one builder, whose dadd K9 replaces where utils/scans.py fold calls
# it; the segmented levels share another, K6's partial stages the
# experiment's `make`)
_PALLAS = {
    "mont_mul": "msm_blst_tpu/fields/pallas_mont.py:281",
    "sos_mul": "msm_blst_tpu/fields/pallas_mont.py:309",
    "point": "msm_blst_tpu/curves/pallas_point.py:49",
    "xyzz_fold": "msm_blst_tpu/curves/pallas_point.py:49",
    "affine_prefix_level": "msm_blst_tpu/msm/pallas_scan.py:463",
    "xyzz_prefix_scan": "msm_blst_tpu/msm/pallas_scan.py:367",
    "seg": "msm_blst_tpu/msm/pallas_scan.py:93",
    "madd_chain": "drivers/microbench.py:44",
    "gather_smem": "drivers/gather_bench.py:95",
}
_PALLAS.update({f"sos_mul_{stage}": "drivers/mxu_experiment.py:81"
                for stage in ("prod", "bytes", "mm1")})


def replaces(k) -> str:
    return (_PALLAS.get(k.name) or _PALLAS.get(k.op)
            or _PALLAS[k.op.split("_")[0]])


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    paths = phase_drivers(dev)
    results = phase_kernels(dev)
    spy_level_shapes()
    g1, g2 = CurveCase("G1"), CurveCase("G2")
    paths.update({
        "G1_ches_device": phase_main_path(dev, g1),
        "G1_ches_device_sos": phase_main_path(dev, g1, "sos"),
        **phase_algorithms(dev, g1, ALGO_SEEDS),
        "G2_ches_device": phase_main_path(dev, g2),
        "G2_ches_device_sos": phase_main_path(dev, g2, "sos", G2_SOS_SEEDS),
        **phase_algorithms(dev, g2, G2_ALGO_SEEDS)})
    for more in (phase_harness(dev, g1, g2), phase_protocol(dev, g1, g2),
                 phase_facade(dev, g1, g2), phase_bign(dev, g1, g2),
                 phase_sharded(dev, g1, g2)):
        if set(more) & set(paths):
            raise AssertionError(f"paths named twice: {set(more) & set(paths)}")
        paths.update(more)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": k.name, "route": "cuda",
         "source": f"msm_blst_tpu_torch/csrc/{k.source}",
         "replaces": replaces(k),
         "launches": sum(p[k.name] for p in paths.values()),
         "launches_by_path": {name: p[k.name] for name, p in paths.items()},
         **results[k.name],
         **{f"at_{key[len(k.name) + 1:]}": r for key, r in results.items()
            if key.startswith(k.name + " ")}}
        for k in counters().values()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
