"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``requires_cuda`` marker and skips without a
GPU. The file imports neither jax nor the JAX package, so it runs where
only PyTorch for CUDA is set up::

    python -m pytest --noconftest tests/test_torch_cuda.py -m requires_cuda

(``--noconftest``: ``tests/conftest.py`` configures jax.) Sizes are small;
``chip_smoke.py`` checks the same kernels at the headline size.
"""

import functools

import numpy as np
import pytest
import torch

# the sibling module by its own name: pytest puts tests/ on sys.path, and a
# package named `tests` elsewhere on the path may shadow ours
from torch_cases import (  # noqa: F401
    CASES,
    CPU,
    NODE_WALK_CASES,
    breakdown_kkt,
    node_rows_in_kernel_order,
    cuda_device,
    random_kkt,
)
from torch_ranks import spawn
from two_pass_lanczos_tpu_torch import (
    CudaKKTOperator,
    DFFusedKKTSolver,
    DFKKTOperator,
    DiagonalOperator,
    FusedKKTSolver,
    KKTOperator,
    SparseOperator,
    generate_mcf_instance,
    lanczos_pass_one_df,
    lanczos_pass_two_with_basis,
    lanczos_standard,
    lanczos_two_pass,
    load_decomposition,
    make_inv_solver,
    make_kkt_operator,
    solve_fAb,
)
from two_pass_lanczos_tpu_torch.algorithms.core import (
    dot_f64,
    pass_one_last_vector,
    pass_one_scan,
    pass_two_scan,
)
from two_pass_lanczos_tpu_torch.convert import decomposition_from_jax
from two_pass_lanczos_tpu_torch.entry import dryrun_multichip
from two_pass_lanczos_tpu_torch.entry import entry as step_entry
from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
from two_pass_lanczos_tpu_torch.functions import padded_f_e1
from two_pass_lanczos_tpu_torch.ops.df import DF, df_add, df_from_f64
from two_pass_lanczos_tpu_torch.ops.eft import eft_check_plain
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    KKTLayout,
    PassOneBuffers,
    eft_check_cuda,
    kkt_matvec_blockrows_cuda,
    kkt_matvec_cuda,
    kkt_shard_matvec,
    kkt_shard_matvec_blockrows_cuda,
    kkt_shard_matvec_cuda,
    pass_one_basis_cuda,
    pass_one_chunk_cuda,
    pass_one_cuda,
    pass_one_steps_cuda,
    pass_two_cuda,
    persistent_grid,
    phase_clock,
    phase_split,
    reset_launches,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
    df_kkt_matvec_cuda,
    df_kkt_matvec_pairs_cuda,
    df_kkt_shard_matvec,
    df_kkt_shard_matvec_cuda,
    df_pass_one_cuda,
    df_pass_one_last_vector,
    df_pass_one_steps_cuda,
    df_pass_two_cuda,
    df_pass_two_steps_cuda,
)
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec
from two_pass_lanczos_tpu_torch.ops.spmv_kernel import (
    kkt_operator_matvec_cuda,
)
from two_pass_lanczos_tpu_torch.parallel import (
    initialize_distributed,
    make_mesh,
)
from two_pass_lanczos_tpu_torch.probes import run as probe_run
from two_pass_lanczos_tpu_torch.probes import stage_split, stream_records
from two_pass_lanczos_tpu_torch.probes.bench import REPLAYS as PROBE_REPLAYS
from two_pass_lanczos_tpu_torch.probes.bench import main as probes_main
from two_pass_lanczos_tpu_torch.probes.gather import (
    STAGE_ONLY,
    cluster_shape,
    gather_cuda as probe_gather_cuda,
    gather_plain as probe_gather_plain,
    two_level,
)
from two_pass_lanczos_tpu_torch.probes.bench import (
    PIPELINE_MODES as PROBE_PIPELINE_MODES,
)
from two_pass_lanczos_tpu_torch.probes.pipeline import (
    STAGE_COUNTS as PIPELINE_STAGE_COUNTS,
    STORES as PIPELINE_STORES,
    TILES as PIPELINE_TILES,
    pipeline_blocks as probe_pipeline_blocks,
    pipeline_cuda as probe_pipeline_cuda,
)
from two_pass_lanczos_tpu_torch.probes.stages import (
    node_sorted_copy,
    stages_cuda as probe_stages_cuda,
    stages_plain,
)
from two_pass_lanczos_tpu_torch.probes.stream import (
    pack_records,
    stream as probe_stream,
    stream_plain,
)
from two_pass_lanczos_tpu_torch.testing import check_reconstruction_stability
from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, b


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _plain_mv(lay):
    return lambda x: kkt_matvec(lay.d, lay.u, lay.v, lay.p, x)


def _y_full(dec, nf, seed):
    y = np.random.default_rng(seed).standard_normal((nf, dec.k_max))
    y[:, dec.steps():] = 0.0
    return y.astype(np.float32)


# --- K1, K2, K3 ------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, cuda_device):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    x = rng.standard_normal(len(d) + p).astype(np.float32)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    before = LAUNCHES["kkt_matvec"]
    y = kkt_matvec_cuda(s.layout, xd)
    torch.cuda.synchronize()
    assert LAUNCHES["kkt_matvec"] == before + 1
    t = torch.from_numpy
    y_ref = kkt_matvec(t(d), t(u), t(v), p, t(x)).numpy()
    m = len(d)
    # the arc part uses the plain version's rounding exactly
    np.testing.assert_array_equal(y[:m].cpu().numpy(), y_ref[:m])
    np.testing.assert_allclose(y.cpu().numpy(), y_ref, rtol=0,
                               atol=2e-5 * np.abs(y_ref).max())
    # fixed-order node sums: bitwise reproducible run to run
    np.testing.assert_array_equal(kkt_matvec_cuda(s.layout, xd).cpu().numpy(),
                                  y.cpu().numpy())


def test_kernels_match_plain_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    k = 20
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    before = dict(LAUNCHES)
    st1 = torch.empty(2, s.n, device=cuda_device)
    dec = s.pass_one(bt, k, state=st1)
    ref, _ = pass_one_scan(_plain_mv(s.layout), bt, k)
    assert dec.steps() == ref.steps() == k
    np.testing.assert_allclose(dec.alphas.cpu().numpy(),
                               ref.alphas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec.betas.cpu().numpy(),
                               ref.betas.cpu().numpy(), rtol=1e-4)
    y = torch.from_numpy(_y_full(dec, 2, seed=9)).to(cuda_device)
    st2 = torch.empty(2, s.n, device=cuda_device)
    x = s.pass_two(bt, dec, y, state=st2)
    x_ref, _ = pass_two_scan(_plain_mv(s.layout), bt, dec, y)
    rel = (torch.linalg.norm(x - x_ref) / torch.linalg.norm(x_ref)).item()
    assert rel < 1e-5, rel
    assert torch.equal(pass_one_last_vector(dec, st1), st2[1])
    assert LAUNCHES["lanczos_pass_one"] == before["lanczos_pass_one"] + 1
    assert LAUNCHES["lanczos_pass_two"] == before["lanczos_pass_two"] + 1
    # the matvecs run as phases of the two persistent launches: no K1 launch
    assert (LAUNCHES["kkt_matvec_in_pass"]
            == before["kkt_matvec_in_pass"] + 2 * k - 1)
    assert LAUNCHES["kkt_matvec"] == before["kkt_matvec"]


def test_solve_on_card_matches_cpu(problem, cuda_device):
    d, u, v, p, b = problem
    k = 25
    x_cpu, _ = FusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=k, f="inv")
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    reset_launches()
    x, dec = s.solve(torch.from_numpy(b).to(cuda_device), k=k, raw=True)
    torch.cuda.synchronize()
    assert LAUNCHES["lanczos_pass_one"] == LAUNCHES["lanczos_pass_two"] == 1
    assert LAUNCHES["kkt_matvec_in_pass"] == 2 * k - 1
    assert sum(LAUNCHES.values()) == 2 * k + 1  # no K1, no other kernel
    assert dec.steps() == k
    assert _rel(x.cpu().numpy(), x_cpu) < 1e-4


def _walk_problem(case):
    """An instance of the node walk's cases and its b; "random" is the
    module's ``problem``."""
    rng = np.random.default_rng(42)
    d, u, v, p = NODE_WALK_CASES[case](rng)
    return d, u, v, p, rng.standard_normal(len(d) + p).astype(np.float32)


#: the edges of the node walk besides the random instance: a node past
#: 4·256 entries (more than four a thread) and arcs with u == v (both
#: entries of an arc in one node's segment)
WALK_CASES = ["random", "wide_hub", "self_loop"]


@pytest.mark.parametrize("case", sorted(NODE_WALK_CASES))
def test_k1_node_rows_walk_in_the_emulated_order_on_card(cuda_device, case):
    # kkt_node_row's order (256 strided partials, then the fixed tree), which
    # K2 and K3 run as their matvec phase, is the emulation's, bit for bit
    d, u, v, p, x = _walk_problem(case)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    y = kkt_matvec_cuda(lay, torch.from_numpy(x).to(cuda_device)).cpu()
    want = node_rows_in_kernel_order(lay.ptr.cpu(), lay.ent.cpu(),
                                     torch.from_numpy(x[:len(d)]))
    assert torch.equal(y[len(d):].view(torch.int32), want.view(torch.int32))


def test_phase_timer_stamps_without_changing_a_bit_on_card(cuda_device):
    d, u, v, p, b = _walk_problem("wide_hub")
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    lay, k = s.layout, 40
    bt = torch.from_numpy(b).to(cuda_device)
    dec = s.pass_one(bt, k)
    y = torch.from_numpy(_y_full(dec, 2, seed=4)).to(cuda_device)
    x = s.pass_two(bt, dec, y)
    _, basis = pass_one_basis_cuda(lay, bt, k, s.tol, s.ztol)
    chunked = _chunked(s, bt, k, 7)
    clocks = {name: phase_clock(name, cuda_device) for name in (
        "lanczos_pass_one", "lanczos_pass_two", "lanczos_pass_one_basis",
        "lanczos_pass_one_chunk")}
    dec_t = pass_one_cuda(lay, bt, k, s.tol, s.ztol,
                          phase_clock=clocks["lanczos_pass_one"])
    x_t = pass_two_cuda(lay, bt, dec, y, s.ztol,
                        phase_clock=clocks["lanczos_pass_two"])
    # K4 and K5 (chunks of 7: the timed steps 20..27 span two chunks)
    dec4, basis_t = pass_one_basis_cuda(
        lay, bt, k, s.tol, s.ztol,
        phase_clock=clocks["lanczos_pass_one_basis"])
    bufs5 = PassOneBuffers.alloc(lay, k, persistent=True)
    for j0 in range(0, k, 7):
        pass_one_chunk_cuda(lay, bufs5, bt, j0, min(7, k - j0), s.tol,
                            s.ztol,
                            phase_clock=clocks["lanczos_pass_one_chunk"])
    torch.cuda.synchronize()
    assert torch.equal(dec_t.alphas, dec.alphas)
    assert torch.equal(dec_t.betas, dec.betas) and torch.equal(x_t, x)
    assert torch.equal(dec4.alphas, dec.alphas)
    assert torch.equal(basis_t, basis)
    _assert_same_run(bufs5, chunked)
    for name, clk in clocks.items():
        assert bool((clk > 0).all())  # every block stamped every phase
        assert bool((clk.diff(dim=2) >= 0).all())  # in order
        split = phase_split(clk, name)
        assert split["step"]["max_us"] > 0


#: the matvecs whose warp rows replaced a block-row kernel, each with its
#: block-row reference entry point: (kernel, reference) on (lay, x)
_WARP_ROWS = {
    "K1": (kkt_matvec_cuda, kkt_matvec_blockrows_cuda),
    "K8_f32": (kkt_operator_matvec_cuda, kkt_matvec_blockrows_cuda),
    "K8_f64": (kkt_operator_matvec_cuda, kkt_matvec_blockrows_cuda),
    # e = 1 (the solver's, and sol_bench's) and a scale that is not exact
    "K7": (kkt_shard_matvec_cuda, kkt_shard_matvec_blockrows_cuda),
    "K7_e0.3": (lambda lay, x: kkt_shard_matvec_cuda(lay, x, e_scale=0.3),
                lambda lay, x: kkt_shard_matvec_blockrows_cuda(
                    lay, x, e_scale=0.3)),
}


@pytest.mark.parametrize("kernel", sorted(_WARP_ROWS))
@pytest.mark.parametrize("case", sorted(NODE_WALK_CASES))
def test_warp_rows_bitwise_their_block_row_reference_on_card(cuda_device,
                                                             case, kernel):
    # one warp a node row (kkt_node_row_warp) gives the bits of one block a
    # node row (kkt_node_row), for every node of the walk's edge cases
    d, u, v, p, x = _walk_problem(case)
    dt = np.float64 if kernel == "K8_f64" else np.float32
    lay = KKTLayout.build(d, u, v, p, cuda_device, dtype=dt)
    xd = torch.from_numpy(x.astype(dt)).to(cuda_device)
    run, ref = _WARP_ROWS[kernel]
    reset_launches()
    y, y_ref = run(lay, xd), ref(lay, xd)
    torch.cuda.synchronize()
    bits = torch.int64 if dt == np.float64 else torch.int32
    assert torch.equal(y.view(bits), y_ref.view(bits))
    counted = {name: c for name, c in LAUNCHES.items() if c}
    want_ref = ("kkt_operator_matvec_blockrows" if kernel == "K8_f64" else
                "kkt_streaming_matvec_blockrows" if kernel.startswith("K7")
                else "kkt_matvec_blockrows")
    want = ("kkt_matvec" if kernel == "K1" else "kkt_streaming_matvec"
            if kernel.startswith("K7") else "kkt_operator_matvec")
    assert counted == {want: 1, want_ref: 1}


def _rows_problem(rows, warps):
    """An instance with fewer node rows than the persistent pass one has
    warps (the walk's random case) or more (``warps + 8`` rows)."""
    if rows == "fewer":
        return _walk_problem("random")
    rng = np.random.default_rng(7)
    d, u, v, p = random_kkt(rng, m=3 * (warps + 8), p=warps + 8)
    return d, u, v, p, rng.standard_normal(len(d) + p).astype(np.float32)


@pytest.mark.parametrize("rows", ["fewer", "more"])
def test_warp_rows_bitwise_the_references_at_any_row_count_on_card(
        cuda_device, rows):
    # K2 (one warp a node row, dealt over the grid's warps) against the
    # per-step launches, and K3 against the plain pass two on K1's matvec,
    # with fewer rows than warps (most warps go straight to the dot) and
    # more (some warps run two rows): the same bits either way
    per_sm, sms = persistent_grid()["lanczos_pass_one"]
    d, u, v, p, b = _rows_problem(rows, 8 * per_sm * sms)
    assert (p > 8 * per_sm * sms) == (rows == "more")
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    lay, k = s.layout, 60
    bt = torch.from_numpy(b).to(cuda_device)
    state = torch.empty(2, s.n, device=cuda_device)
    dec = s.pass_one(bt, k, state=state)
    ref = _six_launch_pass_one(s, bt, k)
    y = torch.from_numpy(_y_full(dec, 2, seed=5)).to(cuda_device)
    st2 = torch.empty(2, s.n, device=cuda_device)
    x = s.pass_two(bt, dec, y, state=st2)
    ref_state = torch.empty_like(st2)
    x_ref, _ = pass_two_scan(lambda z: kkt_matvec_cuda(lay, z), bt, dec, y,
                             state=ref_state)
    torch.cuda.synchronize()
    assert dec.steps() == int(ref.steps[0]) == k
    assert torch.equal(dec.alphas, ref.alphas)
    assert torch.equal(dec.betas, ref.betas)
    assert torch.equal(state, ref.state)
    assert torch.equal(x, x_ref) and torch.equal(st2, ref_state)
    assert torch.equal(pass_one_last_vector(dec, state), st2[1])


def _six_launch_pass_one(s, bt, k, chunk=None, basis=None):
    """Pass one as the per-step launches K2, K4 and K5 (with
    ``s.compensated``: their K6 instances) replaced
    (``pass_one_steps_cuda``): k steps from b in chunks of ``chunk`` (one
    chunk by default), storing K4's rows in ``basis`` when it is given;
    returns the buffers."""
    bufs = PassOneBuffers.alloc(s.layout, k)
    chunk = chunk or k
    for j0 in range(0, k, chunk):
        pass_one_steps_cuda(s.layout, bufs, bt, j0, min(chunk, k - j0),
                            s.tol, s.ztol, basis=basis,
                            compensated=s.compensated)
    return bufs


def _assert_same_run(bufs, ref):
    """Two pass-one runs' buffers agree bit for bit: alpha, beta, ||b||,
    steps, the live flag and the final (v_prev, v_curr)."""
    for name in ("alphas", "betas", "bnorm", "steps", "state"):
        assert torch.equal(getattr(bufs, name), getattr(ref, name)), name
    assert int(bufs.flags[0]) == int(ref.flags[0])


def _chunked(s, bt, k, chunk):
    """K5 (with ``s.compensated``: its K6 instance) as ``pass_one_chunked``
    runs it: chunks of ``chunk`` steps on one set of persistent buffers."""
    bufs = PassOneBuffers.alloc(s.layout, k, persistent=True)
    for j0 in range(0, k, chunk):
        pass_one_chunk_cuda(s.layout, bufs, bt, j0, min(chunk, k - j0), s.tol,
                            s.ztol, compensated=s.compensated)
    return bufs


#: the persistent pass one's instances: K2, K4, K5 and, compensated, K6
COMP = pytest.mark.parametrize("comp", [False, True], ids=["plain", "comp"])


def _name(comp, name):
    """The counter of a pass-one launch: K6's for a compensated one."""
    return "lanczos_pass_one_comp" if comp else name


@COMP
@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("k", [20, 500])
def test_persistent_pass_one_bitwise_six_launch_on_card(cuda_device, k, case,
                                                        comp):
    # K2 (comp: its K6 instance), one cooperative launch, against the
    # per-step launches with the same comp
    d, u, v, p, b = _walk_problem(case)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=comp)
    bt = torch.from_numpy(b).to(cuda_device)
    state = torch.empty(2, s.n, device=cuda_device)
    reset_launches()
    dec = s.pass_one(bt, k, state=state)
    assert LAUNCHES[_name(comp, "lanczos_pass_one")] == 1
    assert LAUNCHES["kkt_matvec"] == 0
    assert LAUNCHES["kkt_matvec_in_pass"] == k
    ref = _six_launch_pass_one(s, bt, k)
    torch.cuda.synchronize()
    assert LAUNCHES["lanczos_pass_one_steps"] == 1
    assert LAUNCHES["kkt_matvec"] == k
    assert dec.steps() == int(ref.steps[0])
    assert torch.equal(dec.alphas, ref.alphas)
    assert torch.equal(dec.betas, ref.betas)
    assert torch.equal(dec.b_norm.reshape(1), ref.bnorm)
    assert torch.equal(state, ref.state)  # v_prev and v_curr
    # the persistent pass is reproducible run to run, whatever the grid
    again = s.pass_one(bt, k)
    assert torch.equal(again.alphas, dec.alphas)
    grids = persistent_grid()
    assert all(per_sm >= 1 and sms >= 1 for per_sm, sms in grids.values())


@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("k", [20, 500])
def test_persistent_pass_two_bitwise_k1_replay_on_card(cuda_device, k, case):
    # the plain pass two on K1's matvec rounds as the two launches a step
    # that K3 replaced (K1, then the update): K3 must give its bits
    d, u, v, p, b = _walk_problem(case)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    dec = s.pass_one(bt, k)
    y = torch.from_numpy(_y_full(dec, 2, seed=3)).to(cuda_device)
    state = torch.empty(2, s.n, device=cuda_device)
    reset_launches()
    x = s.pass_two(bt, dec, y, state=state)
    assert LAUNCHES["lanczos_pass_two"] == 1 and LAUNCHES["kkt_matvec"] == 0
    assert LAUNCHES["kkt_matvec_in_pass"] == k - 1
    ref_state = torch.empty_like(state)
    x_ref, _ = pass_two_scan(lambda z: kkt_matvec_cuda(s.layout, z), bt, dec,
                             y, state=ref_state)
    torch.cuda.synchronize()
    assert torch.equal(x, x_ref)
    assert torch.equal(state, ref_state)


def test_persistent_passes_breakdown_and_zero_b_on_card(cuda_device):
    d, u, v, p, b = breakdown_kkt()
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 12
    state = torch.empty(2, s.n, device=cuda_device)
    dec = s.pass_one(bt, k, state=state)
    steps = dec.steps()
    cpu = FusedKKTSolver(d, u, v, p, device=CPU)
    assert 0 < steps < k and steps == cpu.pass_one(b, k).steps()
    # the breakdown step writes alpha, not beta, and leaves the state
    ref = _six_launch_pass_one(s, bt, k)
    assert steps == int(ref.steps[0]) and int(ref.flags[0]) == 0
    assert torch.equal(dec.alphas, ref.alphas)
    assert torch.equal(dec.betas, ref.betas)
    assert torch.equal(state, ref.state)
    # K3 on the truncated decomposition: no hang, v_steps replayed
    reset_launches()
    x, dec2 = s.solve(bt, k=k, raw=True)
    torch.cuda.synchronize()
    assert dec2.steps() == steps and bool(torch.isfinite(x).all())
    assert LAUNCHES["lanczos_pass_two"] == 1
    x_cpu, _ = cpu.solve(b, k=k)
    assert _rel(x.cpu().numpy(), x_cpu) < 1e-4
    st2 = torch.empty(2, s.n, device=cuda_device)
    y = torch.zeros(k, device=cuda_device)
    s.pass_two(bt, dec, y, state=st2)
    assert torch.equal(pass_one_last_vector(dec, state), st2[1])
    # K3 stops mid-run on the truncated decomposition, bitwise pass two on
    # K1's matvec
    yk = torch.from_numpy(_y_full(dec, 2, seed=5)).to(cuda_device)
    st3, st_ref = torch.empty_like(state), torch.empty_like(state)
    x3 = s.pass_two(bt, dec, yk, state=st3)
    x3_ref, _ = pass_two_scan(lambda z: kkt_matvec_cuda(s.layout, z), bt, dec,
                              yk, state=st_ref)
    assert torch.equal(x3, x3_ref) and torch.equal(st3, st_ref)
    # a b that is zero on every arc (node rows of +0 and -0 terms) and
    # nonzero on its nodes only, through K2 and K3, bitwise the launches
    # they replaced
    rng = np.random.default_rng(9)
    dr, ur, vr, pr = random_kkt(rng, m=300, p=40)
    sr = FusedKKTSolver(dr, ur, vr, pr, device=cuda_device)
    bz = np.zeros(sr.n, np.float32)
    bz[len(dr):] = rng.standard_normal(pr)
    bz_t = torch.from_numpy(bz).to(cuda_device)
    stz = torch.empty(2, sr.n, device=cuda_device)
    decz = sr.pass_one(bz_t, 20, state=stz)
    refz = _six_launch_pass_one(sr, bz_t, 20)
    assert decz.steps() == int(refz.steps[0]) > 0
    assert torch.equal(decz.alphas, refz.alphas)
    assert torch.equal(decz.betas, refz.betas)
    assert torch.equal(stz, refz.state)
    yz = torch.from_numpy(_y_full(decz, 1, seed=6)).to(cuda_device)
    assert torch.equal(
        sr.pass_two(bz_t, decz, yz),
        pass_two_scan(lambda z: kkt_matvec_cuda(sr.layout, z), bz_t, decz,
                      yz)[0])
    # a zero b and a subnormal one: 0 steps and x = 0 through K2 and K3
    for b0 in (np.zeros(s.n, np.float32), np.full(s.n, 1e-42, np.float32)):
        x0, dec0 = s.solve(b0, k=8)
        assert dec0.steps() == 0 and float(dec0.b_norm) <= s.ztol
        np.testing.assert_array_equal(x0, 0.0)


# --- K4: pass one with the basis -------------------------------------------

def test_basis_kernel_matches_plain_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    k = 20
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    reset_launches()
    dec, basis = s.pass_one_with_basis(bt, k)
    assert LAUNCHES["lanczos_pass_one_basis"] == 1
    # the matvecs run as phases of the one cooperative launch: no K1 launch
    assert LAUNCHES["kkt_matvec_in_pass"] == k
    assert LAUNCHES["kkt_matvec"] == 0
    dec2 = s.pass_one(bt, k)
    assert torch.equal(dec.alphas, dec2.alphas)
    assert torch.equal(dec.betas, dec2.betas)
    _, basis_ref = pass_one_scan(_plain_mv(s.layout), bt, k, emit_basis=True)
    rel = (torch.linalg.norm(basis - basis_ref)
           / torch.linalg.norm(basis_ref)).item()
    assert rel < 1e-5, rel
    x1, _ = s.solve(bt, k=k, method="one_pass")
    x_cpu, _ = FusedKKTSolver(d, u, v, p, device=CPU).solve(
        b, k=k, method="one_pass")
    assert _rel(x1, x_cpu) < 1e-4


@pytest.mark.parametrize("nf", [1, 3])
def test_one_pass_product_ignores_tf32_on_card(problem, cuda_device, nf):
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    f = ("inv", "exp", "inv")[:nf] if nf > 1 else "inv"
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        x_f32, dec = s.solve(b, k=20, f=f, method="one_pass", raw=True)
        torch.backends.cuda.matmul.allow_tf32 = True
        x_tf32, _ = s.solve(b, k=20, f=f, method="one_pass", raw=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(x_tf32, x_f32)
    _, basis = s.pass_one_with_basis(b, 20)
    y = np.stack([padded_f_e1(dec, fi).cpu().numpy() * float(dec.b_norm)
                  for fi in (f if nf > 1 else (f,))])
    x64 = y.astype(np.float64) @ basis.cpu().numpy().astype(np.float64)
    got = x_f32.cpu().numpy().reshape(nf, -1)
    assert _rel(got, x64) < 1e-5  # TF32 would be ~1e-3


def test_basis_kernel_rows_past_breakdown_zero_on_card(cuda_device):
    d, u, v, p, b = breakdown_kkt()
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    dec, basis = s.pass_one_with_basis(b, 12)
    steps = dec.steps()
    assert 0 < steps < 12
    assert bool((basis[steps:] == 0).all())
    dec_cpu, basis_cpu = FusedKKTSolver(
        d, u, v, p, device=CPU).pass_one_with_basis(b, 12)
    assert dec_cpu.steps() == steps
    np.testing.assert_allclose(basis.cpu().numpy(), basis_cpu.numpy(),
                               rtol=0, atol=1e-6)
    x0, dec0 = s.solve(np.zeros_like(b), k=8, method="one_pass")
    assert dec0.steps() == 0
    np.testing.assert_array_equal(x0, 0.0)


# --- K5: the resumable pass one --------------------------------------------

@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
def test_chunk_kernel_matches_plain_on_card(problem, cuda_device,
                                            compensated):
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device,
                       compensated=compensated)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 23  # not a multiple of the chunk
    reset_launches()
    got = s.pass_one_chunked(bt, k, chunk=8)
    name = "lanczos_pass_one_comp" if compensated else "lanczos_pass_one_chunk"
    assert LAUNCHES[name] == 3
    # one cooperative launch a chunk with its matvecs inside, compensated
    # (K6's instance) or not
    in_pass = k
    assert LAUNCHES["kkt_matvec_in_pass"] == in_pass
    assert LAUNCHES["kkt_matvec"] == k - in_pass
    ref = s.pass_one(bt, k)
    assert torch.equal(got.alphas, ref.alphas)
    assert torch.equal(got.betas, ref.betas)
    plain = FusedKKTSolver(d, u, v, p, compensated=compensated, device=CPU)
    want = plain.pass_one_chunked(b, k, chunk=8)
    np.testing.assert_allclose(got.alphas.cpu().numpy(), want.alphas.numpy(),
                               rtol=1e-4)


def test_chunk_kernel_stop_bounds_matvecs_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    reset_launches()
    dec = s.pass_one_chunked(b, 40, callback=lambda st, V, sc: st < 11,
                             chunk=8)
    assert dec.steps() == 11 and LAUNCHES["kkt_matvec_in_pass"] <= 16
    assert LAUNCHES["kkt_matvec"] == 0
    assert bool((dec.alphas[11:] == 0).all())
    assert bool((dec.betas[10:] == 0).all())
    # chip_smoke.py's stop: at s = 100 in chunks of 64, at most 128 matvecs
    reset_launches()
    dec = s.pass_one_chunked(b, 500, callback=lambda st, V, sc: st < 100,
                             chunk=64)
    assert dec.steps() == 100 and LAUNCHES["lanczos_pass_one_chunk"] == 2
    assert LAUNCHES["kkt_matvec_in_pass"] <= 128
    assert LAUNCHES["kkt_matvec"] == 0
    assert torch.equal(dec.alphas[:100], s.pass_one(b, 100).alphas)
    zero = s.pass_one_chunked(np.zeros(s.n, np.float32), 8, chunk=4)
    assert zero.steps() == 0
    e1 = np.eye(4, dtype=np.float32)[0]
    tiny = FusedKKTSolver(np.array([2.0, 3.0]), [0, 1], [1, 0], 2,
                          device=cuda_device)
    ref = tiny.pass_one(e1, 6)
    got = tiny.pass_one_chunked(e1, 6, chunk=4)
    assert got.steps() == ref.steps() < 6
    assert torch.equal(got.alphas, ref.alphas)


# --- K4 and K5 against the per-step launches they replaced ----------------

@COMP
@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("k", [20, 500])
def test_persistent_basis_bitwise_per_step_on_card(cuda_device, k, case,
                                                   comp):
    # K4 (comp: its K6 instance), one cooperative launch, against the
    # per-step launches with their rows and the same comp: alpha, beta,
    # ||b||, steps, the final state and every basis row
    d, u, v, p, b = _walk_problem(case)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=comp)
    bt = torch.from_numpy(b).to(cuda_device)
    state = torch.empty(2, s.n, device=cuda_device)
    reset_launches()
    dec, basis = pass_one_basis_cuda(s.layout, bt, k, s.tol, s.ztol,
                                     compensated=comp, state=state)
    assert LAUNCHES[_name(comp, "lanczos_pass_one_basis")] == 1
    assert LAUNCHES["kkt_matvec_in_pass"] == k
    assert LAUNCHES["kkt_matvec"] == 0
    rows = torch.zeros(k, s.n, device=cuda_device)
    ref = _six_launch_pass_one(s, bt, k, basis=rows)
    torch.cuda.synchronize()
    assert dec.steps() == int(ref.steps[0])
    assert torch.equal(dec.alphas, ref.alphas)
    assert torch.equal(dec.betas, ref.betas)
    assert torch.equal(dec.b_norm.reshape(1), ref.bnorm)
    assert torch.equal(state, ref.state)
    assert torch.equal(basis, rows)


@COMP
@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("k", [20, 500])
@pytest.mark.parametrize("chunk", [1, 7, 64, None], ids=str)
def test_persistent_chunks_bitwise_per_step_on_card(cuda_device, k, case,
                                                    chunk, comp):
    # K5 (comp: its K6 instance), one cooperative launch a chunk on the
    # carried state, against the per-step launches with the same comp in
    # the same chunks and in one run of k steps
    d, u, v, p, b = _walk_problem(case)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=comp)
    bt = torch.from_numpy(b).to(cuda_device)
    chunk = chunk or k
    reset_launches()
    got = _chunked(s, bt, k, chunk)
    assert LAUNCHES[_name(comp, "lanczos_pass_one_chunk")] == -(-k // chunk)
    assert LAUNCHES["kkt_matvec_in_pass"] == k
    assert LAUNCHES["kkt_matvec"] == 0
    ref = _six_launch_pass_one(s, bt, k, chunk=chunk)
    torch.cuda.synchronize()
    _assert_same_run(got, ref)
    _assert_same_run(got, _six_launch_pass_one(s, bt, k))
    assert torch.equal(got.scal[0], ref.scal[0])  # the carried beta_prev
    assert torch.equal(got.alphas, s.pass_one(bt, k).alphas)


@COMP
@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 12])
def test_persistent_basis_and_chunks_through_breakdown_on_card(cuda_device,
                                                               chunk, comp):
    # the run breaks down at step 3 (j = 2): with chunk 3 on a chunk's last
    # step, with 1 and 2 on a resumed chunk's first step, with 4 and 12
    # inside the chunk that starts from b; every later chunk starts dead,
    # returns in every block and changes nothing (comp: K6's instances
    # against the compensated per-step launches)
    d, u, v, p, b = breakdown_kkt()
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=comp)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 12
    got = _chunked(s, bt, k, chunk)
    ref = _six_launch_pass_one(s, bt, k, chunk=chunk)
    torch.cuda.synchronize()
    assert int(got.steps[0]) == 3 and int(got.flags[0]) == 0
    _assert_same_run(got, ref)
    before = [t.clone() for t in (got.alphas, got.betas, got.steps,
                                  got.state, got.scal)]
    pass_one_chunk_cuda(s.layout, got, bt, k - 1, 1, s.tol, s.ztol,
                        compensated=comp)
    torch.cuda.synchronize()
    assert all(torch.equal(t, g) for t, g in zip(
        before, (got.alphas, got.betas, got.steps, got.state, got.scal)))
    # K4 through the same breakdown: rows past step 3 stay zero
    state = torch.empty(2, s.n, device=cuda_device)
    dec, basis = pass_one_basis_cuda(s.layout, bt, k, s.tol, s.ztol,
                                     compensated=comp, state=state)
    rows = torch.zeros(k, s.n, device=cuda_device)
    ref4 = _six_launch_pass_one(s, bt, k, basis=rows)
    assert dec.steps() == 3 and bool((basis[3:] == 0).all())
    assert torch.equal(basis, rows) and torch.equal(state, ref4.state)
    assert torch.equal(dec.alphas, ref4.alphas)
    assert torch.equal(dec.betas, ref4.betas)
    # and K2 through it
    dec2 = s.pass_one(bt, k, state=state)
    assert dec2.steps() == 3 and torch.equal(state, ref4.state)
    assert torch.equal(dec2.alphas, ref4.alphas)
    assert torch.equal(dec2.betas, ref4.betas)


@COMP
def test_persistent_basis_and_chunks_zero_b_on_card(cuda_device, problem,
                                                    comp):
    # a zero b and a subnormal one: 0 steps, row 0 = b * 0, the state the
    # per-step launches leave (comp: K6's instances, whose ||b||^2 is
    # compensated, against the compensated per-step launches)
    d, u, v, p, _ = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=comp)
    for b0 in (np.zeros(s.n, np.float32), np.full(s.n, 1e-42, np.float32)):
        bt = torch.from_numpy(b0).to(cuda_device)
        got = _chunked(s, bt, 10, 4)
        ref = _six_launch_pass_one(s, bt, 10, chunk=4)
        state = torch.empty(2, s.n, device=cuda_device)
        dec, basis = pass_one_basis_cuda(s.layout, bt, 10, s.tol, s.ztol,
                                         compensated=comp, state=state)
        rows = torch.zeros(10, s.n, device=cuda_device)
        ref4 = _six_launch_pass_one(s, bt, 10, basis=rows)
        torch.cuda.synchronize()
        assert int(got.steps[0]) == 0 == dec.steps()
        _assert_same_run(got, ref)
        assert torch.equal(basis, rows) and torch.equal(state, ref4.state)
        assert torch.equal(dec.b_norm.reshape(1), ref4.bnorm)


def test_one_pass_and_callback_solves_launch_persistently_on_card(
        problem, cuda_device):
    # the one-pass solve is one K4 launch, the never-stopping callback solve
    # one K5 launch a chunk and K3: no K1 launch in either
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 500
    reset_launches()
    s.solve(bt, k=k, method="one_pass", raw=True)
    torch.cuda.synchronize()
    got = {name: c for name, c in LAUNCHES.items() if c}
    assert got == {"lanczos_pass_one_basis": 1, "kkt_matvec_in_pass": k}
    reset_launches()
    s.solve(bt, k=k, raw=True, callback=lambda st, V, sc: True,
            callback_chunk=64)
    torch.cuda.synchronize()
    got = {name: c for name, c in LAUNCHES.items() if c}
    assert got == {"lanczos_pass_one_chunk": 8, "lanczos_pass_two": 1,
                   "kkt_matvec_in_pass": 2 * k - 1}


# --- K6: the compensated instances -----------------------------------------

def test_compensated_solves_launch_persistently_on_card(problem,
                                                        cuda_device):
    # K6's instances of K2, K4 and K5: the two-pass, one-pass and callback
    # solves launch one cooperative kernel a pass (a chunk), no K1 and no
    # per-step launch
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=True)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 500
    for kwargs, want in (
            ({}, {"lanczos_pass_one_comp": 1, "lanczos_pass_two": 1,
                  "kkt_matvec_in_pass": 2 * k - 1}),
            ({"method": "one_pass"}, {"lanczos_pass_one_comp": 1,
                                      "kkt_matvec_in_pass": k}),
            ({"callback": lambda st, V, sc: True, "callback_chunk": 64},
             {"lanczos_pass_one_comp": 8, "lanczos_pass_two": 1,
              "kkt_matvec_in_pass": 2 * k - 1})):
        reset_launches()
        x, dec = s.solve(bt, k=k, raw=True, **kwargs)
        torch.cuda.synchronize()
        got = {name: c for name, c in LAUNCHES.items() if c}
        assert got == want, kwargs
        assert dec.steps() == k and bool(torch.isfinite(x).all())


def test_compensated_kernel_matches_plain_on_card(cuda_device):
    # long reductions (n = 202,000), so that plain K2's f32 dots sit
    # measurably off the f64-dot version
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng, m=200_000, p=2_000)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=True)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 20
    reset_launches()
    dec = s.pass_one(bt, k)
    assert LAUNCHES["lanczos_pass_one_comp"] == 1
    assert LAUNCHES["lanczos_pass_one"] == LAUNCHES["kkt_matvec"] == 0
    assert LAUNCHES["kkt_matvec_in_pass"] == k
    # the reference runs K1's matvec, so that only the reductions differ
    ref, _ = pass_one_scan(lambda x: kkt_matvec_cuda(s.layout, x), bt, k,
                           dot=dot_f64)
    np.testing.assert_allclose(dec.alphas.cpu().numpy(),
                               ref.alphas.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(dec.betas.cpu().numpy(),
                               ref.betas.cpu().numpy(), rtol=1e-5)
    # an uncompensated build also meets rtol 1e-5: hold the kernel well
    # inside plain K2's own distance from the f64-dot version
    plain = FusedKKTSolver(d, u, v, p, device=cuda_device).pass_one(bt, k)

    def dist(x):
        return max(float((x.alphas - ref.alphas).abs().max()),
                   float((x.betas - ref.betas).abs().max()))

    assert 0 < dist(plain) and dist(dec) <= 0.25 * dist(plain), (
        dist(dec), dist(plain))
    dec1, _ = s.pass_one_with_basis(bt, k)
    assert torch.equal(dec1.alphas, dec.alphas)


def test_compensated_alphas_closer_to_f64_on_card(cuda_device):
    # the instance of tests/test_fused.py::test_compensated_alphas_closer_to_f64
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng, m=1200, p=300)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    k = 6
    t = torch.from_numpy
    o64, _ = pass_one_scan(
        lambda x: kkt_matvec(t(d.astype(np.float64)), t(u), t(v), p, x),
        t(b.astype(np.float64)), k)
    a64 = o64.alphas.numpy()
    errs = []
    for comp in (False, True):
        s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=comp)
        a = s.pass_one(b, k).alphas.cpu().numpy().astype(np.float64)
        errs.append(np.abs(a - a64).max())
    assert errs[1] < errs[0], errs


# --- K13: the error-free transformations -----------------------------------

def test_eft_kernel_exact_on_card(cuda_device):
    a = torch.full((300,), 1.0 + 2.0 ** -12, device=cuda_device)
    b = torch.full((300,), 2.0 ** -30, device=cuda_device)
    reset_launches()
    got = eft_check_cuda(a, b).cpu()
    assert LAUNCHES["eft_check"] == 1
    exact = torch.tensor([1.0 + 2.0 ** -12, 2.0 ** -30, 1.0 + 2.0 ** -11,
                          2.0 ** -24, 1.0 + 2.0 ** -12, 2.0 ** -30])
    assert torch.equal(got, exact[:, None].expand(6, 300))
    # random inputs: bitwise the plain twin
    rng = np.random.default_rng(0)
    ra = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    rb = torch.from_numpy(rng.standard_normal(1000).astype(np.float32) * 1e-5)
    assert torch.equal(eft_check_cuda(ra.to(cuda_device), rb.to(cuda_device))
                       .cpu(), eft_check_plain(ra, rb))


# --- K8: the generic operators' matvec -------------------------------------

def _node_bound(lay, x, eps):
    """2·deg·eps·Σ|x_a| per node: two summation orders of one node sum."""
    m = lay.m
    absum = torch.zeros(lay.p, dtype=x.dtype, device=x.device)
    absum.index_add_(0, lay.u, x[:m].abs()).index_add_(0, lay.v, x[:m].abs())
    deg = (lay.ptr[1:] - lay.ptr[:-1]).to(x.dtype)
    return 2 * deg * eps * absum


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_kernel_matches_plain_on_card(case, dtype, cuda_device):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    x = torch.from_numpy(rng.standard_normal(len(d) + p)).to(dtype)
    op = make_kkt_operator(d, u, v, p, dtype=dtype, device=cuda_device)
    assert isinstance(op, CudaKKTOperator) and op.dtype == dtype
    xd = x.to(cuda_device)
    before = LAUNCHES["kkt_operator_matvec"]
    y = op.matvec(xd)
    torch.cuda.synchronize()
    assert LAUNCHES["kkt_operator_matvec"] == before + 1
    lay = op.layout
    y_ref = kkt_matvec(lay.d.cpu(), lay.u.cpu(), lay.v.cpu(), p, x)
    m = len(d)
    # the arc part rounds as the plain version; the node part sums in
    # another fixed order
    assert torch.equal(y[:m].cpu(), y_ref[:m])
    bound = _node_bound(lay, xd, torch.finfo(dtype).eps).cpu()
    assert bool(((y[m:].cpu() - y_ref[m:]).abs() <= bound).all())
    assert torch.equal(op.matvec(xd), y)  # bitwise reproducible
    # KKTOperator on the card runs the same kernel, never index_add_
    plain_class = KKTOperator(d, u, v, p, dtype=dtype, device=cuda_device)
    assert torch.equal(plain_class.matvec(xd), y)
    assert LAUNCHES["kkt_operator_matvec"] == before + 3
    with pytest.raises(ValueError, match="plain"):
        make_kkt_operator(d, u, v, p, backend="plain", device=cuda_device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_generic_two_pass_basis_bitwise_on_card(problem, cuda_device, dtype):
    d, u, v, p, b = problem
    k = 25
    op = make_kkt_operator(d, u, v, p, dtype=dtype, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device, dtype)
    reset_launches()
    dec, basis = lanczos_standard(op, bt, k)
    y = torch.ones(k, dtype=dtype, device=cuda_device)
    _, regen = lanczos_pass_two_with_basis(op, bt, dec, y)
    assert dec.steps() == k
    assert torch.equal(regen, basis)  # basis_drift_fro == 0 on the card
    assert LAUNCHES["kkt_operator_matvec"] == 2 * k - 1
    assert LAUNCHES["kkt_matvec"] == 0
    reset_launches()
    x = solve_fAb(op, bt, k=k, f="inv")
    assert LAUNCHES["kkt_operator_matvec"] == 2 * k - 1
    x_host = lanczos_two_pass(op, bt, k, make_inv_solver())
    cpu = make_kkt_operator(d, u, v, p, dtype=dtype, device="cpu")
    x_cpu = solve_fAb(cpu, bt.cpu(), k=k, f="inv")
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert _rel(x.cpu().numpy(), x_cpu.numpy()) < tol
    assert _rel(x_host.cpu().numpy(), x_cpu.numpy()) < tol


def test_sparse_operator_replay_bitwise_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    arrays = KKTArrays(quad_costs=d.astype(np.float64), arc_u=u, arc_v=v,
                       num_nodes=p, num_arcs=len(d))
    op = SparseOperator(kkt_sorted_coo(arrays, device=cuda_device),
                        device=cuda_device)
    bt = torch.from_numpy(b.astype(np.float64)).to(cuda_device)
    report = check_reconstruction_stability(op, bt, 30)
    assert report.value == 0.0
    kkt = make_kkt_operator(d.astype(np.float64), u, v, p,
                            dtype=torch.float64, device=cuda_device)
    y = op.matvec(bt)
    assert torch.equal(op.matvec(bt), y)
    assert _rel(y.cpu().numpy(), kkt.matvec(bt).cpu().numpy()) < 1e-14
    x = lanczos_two_pass(DiagonalOperator(np.arange(1.0, 101.0),
                                          device=cuda_device),
                         np.ones(100), 30, make_inv_solver())
    assert _rel(x.cpu().numpy(), 1.0 / np.arange(1.0, 101.0)) < 1e-3


# --- K11, K9, K10: the double-float tier -----------------------------------

def _df_node_bound(lay, x2):
    """Two compensated folds of one node sum differ by at most
    8·(deg+1)·2⁻⁴⁸·Σ|x_a| (f64): each df_add2 of partial sums a, b errs by
    ≤ 3·2⁻⁴⁸·(|a| + |b|), a fold of deg terms adds ≤ deg such errors over
    partial sums bounded by Σ|x_a|, and the plain version's final df_sub
    adds one more."""
    m = lay.m
    xa = (x2[0, :m].double() + x2[1, :m].double()).abs()
    absum = torch.zeros(lay.p, dtype=torch.float64, device=x2.device)
    absum.index_add_(0, lay.u, xa).index_add_(0, lay.v, xa)
    deg = (lay.ptr[1:] - lay.ptr[:-1]).double()
    return 8 * (deg + 1) * 2.0 ** -48 * absum


def _df_problem(rng, m=700, p=300):
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    return rng.uniform(0.5, 5.0, m), u, v, p


@pytest.mark.parametrize("case", sorted(CASES))
def test_df_matvec_kernel_matches_plain_on_card(case, cuda_device,
                                                monkeypatch):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    d64 = d.astype(np.float64) * (1.0 + rng.uniform(0, 1e-7, len(d)))
    x64 = rng.standard_normal(len(d) + p)
    op = DFKKTOperator.from_f64(d64, u, v, p, device=cuda_device)
    xdf = df_from_f64(x64, cuda_device)
    x2 = torch.stack([xdf.hi, xdf.lo])
    reset_launches()
    y2 = df_kkt_matvec_cuda(op.layout, op.d2, x2)
    torch.cuda.synchronize()
    assert LAUNCHES["df_kkt_matvec"] == 1
    ref = op.plain_matvec_df(xdf)
    m = len(d)
    # the arc part rounds as the plain version, in both planes
    assert torch.equal(y2[0, :m], ref.hi[:m])
    assert torch.equal(y2[1, :m], ref.lo[:m])
    # the node part folds in another fixed order
    got = y2[0, m:].double() + y2[1, m:].double()
    want = ref.hi[m:].double() + ref.lo[m:].double()
    assert bool(((got - want).abs() <= _df_node_bound(op.layout, x2)).all())
    assert torch.equal(df_kkt_matvec_cuda(op.layout, op.d2, x2), y2)
    # DFKKTOperator.matvec_df on the card is the pair K11, never the plain
    # fold: the planar K11's values
    monkeypatch.setattr(DFKKTOperator, "plain_matvec_df",
                        lambda *a: pytest.fail("plain df matvec on the card"))
    y = op.matvec_df(xdf)
    assert LAUNCHES["df_kkt_matvec"] == 2
    assert LAUNCHES["df_kkt_matvec_pairs"] == 1
    assert torch.equal(y.hi, y2[0]) and torch.equal(y.lo, y2[1])
    # and near the f64 truth
    t = torch.from_numpy
    truth = kkt_matvec(t(d64), t(u), t(v), p, t(x64)).numpy()
    y64 = (y2[0].double() + y2[1].double()).cpu().numpy()
    assert np.abs(y64 - truth).max() <= 1e-13 * np.abs(truth).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_df_matvec_bitwise_planar_on_card(case, cuda_device):
    # the pair K11 computes the planar K11's values, in both planes, bit for
    # bit: on a random x, on one with signed zeros and subnormals in both
    # planes, and on a zero x (y = 0)
    rng = np.random.default_rng(6)
    d, u, v, p = CASES[case](rng)
    n = len(d) + p
    d64 = d.astype(np.float64) * (1.0 + rng.uniform(0, 1e-7, len(d)))
    op = DFKKTOperator(d64, u, v, p, device=cuda_device)
    xdf = df_from_f64(rng.standard_normal(n), cuda_device)
    odd = torch.stack([xdf.hi, xdf.lo]).clone()
    odd[:, ::3] = -0.0
    odd[:, 1::5] = 1e-40
    odd[1, 2::7] = -1e-42
    for x2 in (torch.stack([xdf.hi, xdf.lo]), odd,
               torch.zeros(2, n, device=cuda_device)):
        reset_launches()
        y2 = df_kkt_matvec_cuda(op.layout, op.d2, x2)
        yp = df_kkt_matvec_pairs_cuda(op.layout, op.d2, x2.T.contiguous())
        torch.cuda.synchronize()
        assert LAUNCHES["df_kkt_matvec"] == LAUNCHES[
            "df_kkt_matvec_pairs"] == 1
        assert tuple(yp.shape) == (n, 2)
        assert torch.equal(yp.T, y2)
        assert torch.equal(yp.T.signbit(), y2.signbit())  # -0 stays -0
    assert not bool(y2.any())


def test_df_pass_kernels_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    d, u, v, p = _df_problem(rng)
    b = rng.standard_normal(len(d) + p)
    k = 20
    s = DFFusedKKTSolver(d, u, v, p, device=cuda_device)
    b2 = s.pack(torch.from_numpy(b).to(cuda_device))
    reset_launches()
    st1 = torch.empty(2, 2, s.n, device=cuda_device)
    coeffs = s.pass_one(b2, k, state=st1)
    torch.cuda.synchronize()
    # the matvecs run as phases of the persistent K9: no K11 launch
    assert LAUNCHES["df_lanczos_pass_one"] == 1
    assert LAUNCHES["df_kkt_matvec_in_pass"] == k
    assert LAUNCHES["df_kkt_matvec"] == 0
    ah, al, bh, bl, bn2, steps = coeffs
    assert int(steps[0]) == k
    ref = lanczos_pass_one_df(DFKKTOperator.from_f64(d, u, v, p, device=CPU),
                              b, k)
    a64 = (ah.double() + al.double()).cpu().numpy()
    b64 = (bh.double() + bl.double()).cpu().numpy()
    atol = 1e-11 * max(1.0, np.abs(ref.alphas_f64()).max())
    np.testing.assert_allclose(a64, ref.alphas_f64(), rtol=0, atol=atol)
    np.testing.assert_allclose(b64[:k - 1], ref.betas_f64(), rtol=0,
                               atol=atol)
    bn = float(bn2[0].double() + bn2[1].double())
    assert abs(bn - np.linalg.norm(b)) < 1e-12 * np.linalg.norm(b)
    # K10 regenerates K9's basis: v_k bitwise in both planes
    y = torch.zeros(2, k, device=cuda_device)
    st2 = torch.empty(2, 2, s.n, device=cuda_device)
    s.pass_two(b2, coeffs, y[0], y[1], state=st2)
    torch.cuda.synchronize()
    assert LAUNCHES["df_lanczos_pass_two"] == 1
    assert LAUNCHES["df_kkt_matvec_in_pass"] == 2 * k - 1
    assert LAUNCHES["df_kkt_matvec"] == 0
    assert torch.equal(df_pass_one_last_vector(coeffs, st1), st2[1])
    # the whole solve against the plain one on the CPU
    x, (al64, be64, st) = s.solve(b, k=k, f="inv")
    x_cpu, _ = DFFusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=k)
    assert x.dtype == torch.float64 and x.is_cuda and st == k
    assert _rel(x.cpu().numpy(), x_cpu.numpy()) < 1e-10


@functools.lru_cache(maxsize=None)
def _df_walk_problem(case):
    """A df instance (f64 costs) and its f64 b: the headline,
    ``generate_mcf_instance(500_000, rho=3, instance_id=1)``, or one of the
    node walk's cases."""
    rng = np.random.default_rng(7)
    if case == "headline":
        inst = generate_mcf_instance(500_000, rho=3, instance_id=1)
        d, u, v, p = (inst.quad_costs, inst.arc_u, inst.arc_v,
                      inst.num_nodes)
    else:
        d, u, v, p = NODE_WALK_CASES[case](rng)
        d = d.astype(np.float64) * (1.0 + rng.uniform(0, 1e-7, len(d)))
    return d, u, v, p, rng.standard_normal(len(d) + p)


def _df_steps_solve(s, b2, k, seed):
    """K9 and K10 and their per-step references on one b: (coeffs, state,
    x) of each route, with the same y (zero beyond steps_taken)."""
    out = []
    for one, two in ((df_pass_one_cuda, df_pass_two_cuda),
                     (df_pass_one_steps_cuda, df_pass_two_steps_cuda)):
        st1 = torch.empty(2, 2, s.n, device=b2.device)
        c = one(s.layout, s.d2, b2, k, s.tol, s.ztol, state=st1)
        if not out:
            y = np.random.default_rng(seed).standard_normal((2, k))
            y[:, int(c[5][0]):] = 0.0
            y2 = torch.from_numpy(y.astype(np.float32)).to(b2.device)
        st2 = torch.empty_like(st1)
        x2 = two(s.layout, s.d2, b2, c, y2, s.ztol, state=st2)
        out.append((c, st1, x2, st2))
    torch.cuda.synchronize()
    return out


def _assert_df_routes_equal(got, ref):
    (c, st1, x2, st2), (c_ref, st1_ref, x2_ref, st2_ref) = got, ref
    for a, b in zip(c, c_ref):  # alpha, beta hi and lo, ||b||, steps
        assert torch.equal(a, b)
    assert torch.equal(st1, st1_ref)  # v_prev and v_curr, hi and lo
    assert torch.equal(x2, x2_ref) and torch.equal(st2, st2_ref)


DF_WALK_CASES = ["headline", "wide_hub", "self_loop"]


@pytest.mark.parametrize("case", DF_WALK_CASES)
@pytest.mark.parametrize("k", [20, 500])
def test_persistent_df_pass_one_bitwise_per_step_on_card(cuda_device, k,
                                                         case):
    d, u, v, p, b = _df_walk_problem(case)
    s = DFFusedKKTSolver(d, u, v, p, device=cuda_device)
    b2 = s.pack(torch.from_numpy(b).to(cuda_device))
    reset_launches()
    st = torch.empty(2, 2, s.n, device=cuda_device)
    c = s.pass_one(b2, k, state=st)
    assert LAUNCHES["df_lanczos_pass_one"] == 1
    assert LAUNCHES["df_kkt_matvec_in_pass"] == k
    assert LAUNCHES["df_kkt_matvec"] == 0
    st_ref = torch.empty_like(st)
    c_ref = df_pass_one_steps_cuda(s.layout, s.d2, b2, k, s.tol, s.ztol,
                                   state=st_ref)
    torch.cuda.synchronize()
    assert LAUNCHES["df_lanczos_pass_one_steps"] == 1
    assert LAUNCHES["df_kkt_matvec"] == k
    for a, r in zip(c, c_ref):  # alpha, beta hi and lo, ||b||, steps
        assert torch.equal(a, r)
    assert torch.equal(st, st_ref)  # v_prev and v_curr, hi and lo
    # reproducible run to run, whatever the grid
    again = s.pass_one(b2, k)
    assert torch.equal(again[0], c[0]) and torch.equal(again[3], c[3])
    grids = persistent_grid()
    assert all(grids[name][0] >= 1 for name in
               ("df_lanczos_pass_one", "df_lanczos_pass_two"))


@pytest.mark.parametrize("case", DF_WALK_CASES)
@pytest.mark.parametrize("k", [20, 500])
def test_persistent_df_pass_two_bitwise_per_step_on_card(cuda_device, k,
                                                         case):
    d, u, v, p, b = _df_walk_problem(case)
    s = DFFusedKKTSolver(d, u, v, p, device=cuda_device)
    b2 = s.pack(torch.from_numpy(b).to(cuda_device))
    reset_launches()
    got, ref = _df_steps_solve(s, b2, k, seed=3)
    assert LAUNCHES["df_lanczos_pass_two"] == 1
    assert LAUNCHES["df_lanczos_pass_two_steps"] == 1
    assert LAUNCHES["df_kkt_matvec_in_pass"] == 2 * k - 1
    assert LAUNCHES["df_kkt_matvec"] == 2 * k - 1  # the references' K11
    _assert_df_routes_equal(got, ref)
    # pass two's hi and lo v_s are pass one's
    c, st1, _, st2 = got
    assert torch.equal(df_pass_one_last_vector(c, st1), st2[1])


def test_df_phase_timer_stamps_without_changing_a_bit_on_card(cuda_device):
    d, u, v, p, b = _df_walk_problem("wide_hub")
    s = DFFusedKKTSolver(d, u, v, p, device=cuda_device)
    b2 = s.pack(torch.from_numpy(b).to(cuda_device))
    k = 40
    c = s.pass_one(b2, k)
    y2 = torch.from_numpy(np.random.default_rng(4).standard_normal((2, k))
                          .astype(np.float32)).to(cuda_device)
    x2 = s.pass_two(b2, c, y2[0], y2[1])
    clocks = {name: phase_clock(name, cuda_device)
              for name in ("df_lanczos_pass_one", "df_lanczos_pass_two")}
    c_t = df_pass_one_cuda(s.layout, s.d2, b2, k, s.tol, s.ztol,
                           phase_clock=clocks["df_lanczos_pass_one"])
    x_t = df_pass_two_cuda(s.layout, s.d2, b2, c, y2, s.ztol,
                           phase_clock=clocks["df_lanczos_pass_two"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(c_t, c))
    assert torch.equal(x_t, x2)
    for name, clk in clocks.items():
        assert bool((clk > 0).all())  # every block stamped every phase
        assert bool((clk.diff(dim=2) >= 0).all())  # in order
        assert phase_split(clk, name)["step"]["max_us"] > 0


def test_df_breakdown_and_zero_b_on_card(cuda_device):
    d, u, v, p, b = breakdown_kkt()
    s = DFFusedKKTSolver(d.astype(np.float64), u, v, p, device=cuda_device)
    coeffs = s.pass_one(b.astype(np.float64), 12)
    steps = int(coeffs[5][0])
    ref = DFFusedKKTSolver(d.astype(np.float64), u, v, p,
                           device=CPU).pass_one(b.astype(np.float64), 12)
    assert 0 < steps < 12 and steps == int(ref[5][0])
    # the step that breaks down writes alpha but not beta
    assert float(coeffs[0][steps - 1]) != 0.0
    assert float(coeffs[2][steps - 1]) == 0.0
    assert bool((coeffs[0][steps:] == 0).all())
    x, (_, _, st) = s.solve(b.astype(np.float64), k=12)
    assert st == steps and bool(torch.isfinite(x).all())
    # a zero b: 0 steps and x = 0; a subnormal b: the same, never NaN
    n = s.n
    x0, (_, _, s0) = s.solve(np.zeros(n), k=5)
    assert s0 == 0 and bool((x0 == 0).all())
    b_sub = s.pack(np.full(n, 1e-42))
    c_sub = s.pass_one(b_sub, 4)
    assert int(c_sub[5][0]) == 0
    zero = torch.zeros(4, device=cuda_device)
    x_sub = s.pass_two(b_sub, c_sub, zero, zero)
    assert bool(torch.isfinite(x_sub).all()) and bool((x_sub == 0).all())
    # the persistent K9 and K10 bitwise their per-step references: through
    # the breakdown (every block leaves the loop at the step that breaks
    # down, which writes alpha, not beta, and leaves the state), on a b
    # that is zero on every arc, on a zero and a subnormal b
    bz = np.zeros(n)
    bz[len(d):] = np.random.default_rng(9).standard_normal(p)
    for bb, k in ((b.astype(np.float64), 12), (bz, 20), (np.zeros(n), 5),
                  (np.full(n, 1e-42), 4)):
        got, ref = _df_steps_solve(s, s.pack(bb), k, seed=5)
        _assert_df_routes_equal(got, ref)
        assert bool(torch.isfinite(got[2]).all())
    assert int(got[0][5][0]) == 0 and bool((got[2] == 0).all())


# --- K7, K12: the shard matvecs of the sharded solvers --------------------

def _local(x, ix, m):
    """A shard's local vector [x_a of its arcs, x_n] (last axis)."""
    return torch.cat([x[..., ix[0]:ix[-1] + 1], x[..., m:]], dim=-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_matvec_kernel_matches_k1_on_card(case, cuda_device):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    m = len(d)
    x = torch.from_numpy(rng.standard_normal(m + p).astype(np.float32))
    xd = x.to(cuda_device)
    whole = KKTLayout.build(d, u, v, p, cuda_device)
    reset_launches()
    y1 = kkt_matvec_cuda(whole, xd)
    y7 = kkt_shard_matvec_cuda(whole, xd)
    torch.cuda.synchronize()
    assert LAUNCHES["kkt_streaming_matvec"] == 1
    assert torch.equal(y7, y1)  # one shard at e = 1: bitwise K1
    bound = _node_bound(whole, xd, torch.finfo(torch.float32).eps)
    parts = []
    for ix in np.array_split(np.arange(m), 4):
        lay = KKTLayout.build(d[ix], u[ix], v[ix], p, cuda_device)
        xl = _local(xd, ix, m)
        yl = kkt_shard_matvec_cuda(lay, xl)
        # the arc part is K1's slice, bit for bit
        assert torch.equal(yl[:len(ix)], y1[ix[0]:ix[-1] + 1])
        parts.append(yl[len(ix):])
        # against the plain version on the CPU, at e = 1 and e = 2
        cpu = KKTLayout.build(d[ix], u[ix], v[ix], p, CPU)
        for e in (1.0, 2.0):
            ye = kkt_shard_matvec_cuda(lay, xl, e_scale=e).cpu()
            ref = kkt_shard_matvec(cpu, xl.cpu(), e_scale=e)
            assert torch.equal(ye[:len(ix)], ref[:len(ix)])
            assert bool(((ye[len(ix):] - ref[len(ix):]).abs()
                         <= e * bound.cpu()).all())
    folded = parts[0]
    for s_ in parts[1:]:
        folded = folded + s_
    assert bool(((folded - y1[m:]).abs() <= bound).all())
    assert LAUNCHES["kkt_streaming_matvec"] == 13 and LAUNCHES["kkt_matvec"] == 1


def test_shard_matvec_kernel_writes_into_out_on_card(cuda_device):
    """``out=`` (the speed-of-light graphs' alternating outputs) gives K7's
    bits in place; x itself is refused."""
    rng = np.random.default_rng(6)
    d, u, v, p = CASES["random"](rng)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    x = torch.from_numpy(rng.standard_normal(len(d) + p).astype(
        np.float32)).to(cuda_device)
    out = torch.full_like(x, float("nan"))
    assert kkt_shard_matvec_cuda(lay, x, out=out) is out
    assert torch.equal(out, kkt_shard_matvec_cuda(lay, x))
    with pytest.raises(ValueError, match="out must not be x"):
        kkt_shard_matvec_cuda(lay, x, out=x)
    with pytest.raises(ValueError, match="out"):
        kkt_shard_matvec_cuda(lay, x, out=out[:-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_df_shard_matvec_kernel_matches_k11_on_card(case, cuda_device):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    m = len(d)
    d64 = d.astype(np.float64) * (1.0 + rng.uniform(0, 1e-7, m))
    xdf = df_from_f64(rng.standard_normal(m + p), cuda_device)
    x2 = torch.stack([xdf.hi, xdf.lo])
    xp = x2.T.contiguous()  # K12 takes (hi, lo) pairs
    whole = DFKKTOperator(d64, u, v, p, device=cuda_device)
    reset_launches()
    y11 = df_kkt_matvec_cuda(whole.layout, whole.d2, x2)
    y11p = df_kkt_matvec_pairs_cuda(whole.layout, whole.d2, xp)
    y12 = df_kkt_shard_matvec_cuda(whole.layout, whole.d2, xp)
    torch.cuda.synchronize()
    assert LAUNCHES["df_kkt_streaming_matvec"] == 1
    # one shard: bitwise both K11 instances in both planes
    assert torch.equal(y12, y11p) and torch.equal(y12.T, y11)
    bound = _df_node_bound(whole.layout, x2)
    acc = None
    for ix in np.array_split(np.arange(m), 4):
        op = DFKKTOperator(d64[ix], u[ix], v[ix], p, device=cuda_device)
        xl = _local(x2, ix, m).T.contiguous()
        yl = df_kkt_shard_matvec(op, xl)
        mine = len(ix)
        assert torch.equal(yl[:mine], y11p[ix[0]:ix[-1] + 1])
        part = DF(yl[mine:, 0], yl[mine:, 1])
        acc = part if acc is None else df_add(acc, part)
        # against the plain version (the shard's table fold) on the CPU
        ref = df_kkt_shard_matvec(
            DFKKTOperator(d64[ix], u[ix], v[ix], p, device=CPU), xl.cpu())
        assert torch.equal(yl[:mine].cpu(), ref[:mine])
        got = yl[mine:, 0].double() + yl[mine:, 1].double()
        want = ref[mine:, 0].double() + ref[mine:, 1].double()
        assert bool(((got.cpu() - want).abs() <= bound.cpu()).all())
    folded = acc.hi.double() + acc.lo.double()
    want = y11[0, m:].double() + y11[1, m:].double()
    assert bool(((folded - want).abs() <= bound).all())
    assert LAUNCHES["df_kkt_streaming_matvec"] == 5
    assert LAUNCHES["df_kkt_matvec"] == LAUNCHES["df_kkt_matvec_pairs"] == 1


def test_sharded_solvers_on_a_one_rank_nccl_group_on_card(problem,
                                                          cuda_device,
                                                          tmp_path):
    d, u, v, p, b = problem
    d64 = d.astype(np.float64) * (1.0 + np.linspace(0, 1e-7, len(d)))
    k = 20
    [rank0] = spawn(1, [("path", "card_path",
                         dict(d=d, u=u, v=v, p=p, b=b, d64=d64, k=k))],
                    tmp_path, device="cuda")
    r = rank0["path"]
    # K7 and K12 are the only matvecs of the sharded paths on the card
    assert r["f32_launches"]["kkt_streaming_matvec"] == 2 * k - 1
    assert sum(r["f32_launches"].values()) == 2 * k - 1
    assert r["df_launches"]["df_kkt_streaming_matvec"] == 2 * k - 1
    assert sum(r["df_launches"].values()) == 2 * k - 1
    assert r["dec"]["steps"] == r["dec1"]["steps"] == k
    np.testing.assert_allclose(r["dec"]["alphas"], r["dec1"]["alphas"],
                               rtol=2e-4)
    assert _rel(r["x"], r["x1"]) < 1e-4
    a1 = r["c1"]["alphas"]
    np.testing.assert_allclose(r["c"]["alphas"], a1, rtol=0,
                               atol=1e-11 * max(1.0, np.abs(a1).max()))
    assert r["c"]["steps"] == k and _rel(r["xd"], r["xd1"]) < 1e-10


def test_sharded_solvers_across_four_cards(problem, cuda_device, tmp_path):
    """Four NCCL ranks, one card each: every rank runs only K7 / K12 and
    holds the same x, within the f32 and df tolerances of one card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    d, u, v, p, b = problem
    d64 = d.astype(np.float64) * (1.0 + np.linspace(0, 1e-7, len(d)))
    k = 20
    ranks = spawn(4, [("path", "card_path",
                       dict(d=d, u=u, v=v, p=p, b=b, d64=d64, k=k))],
                  tmp_path, device="cuda")
    for r in (rank["path"] for rank in ranks):
        assert r["f32_launches"]["kkt_streaming_matvec"] == 2 * k - 1
        assert sum(r["f32_launches"].values()) == 2 * k - 1
        assert r["df_launches"]["df_kkt_streaming_matvec"] == 2 * k - 1
        assert sum(r["df_launches"].values()) == 2 * k - 1
        assert np.array_equal(r["x"], ranks[0]["path"]["x"])
        assert np.array_equal(r["xd"], ranks[0]["path"]["xd"])
        np.testing.assert_allclose(r["dec"]["alphas"], r["dec1"]["alphas"],
                                   rtol=2e-4)
        assert _rel(r["x"], r["x1"]) < 1e-4
        a1 = r["c1"]["alphas"]
        np.testing.assert_allclose(r["c"]["alphas"], a1, rtol=0,
                                   atol=1e-11 * max(1.0, np.abs(a1).max()))
        assert _rel(r["xd"], r["xd1"]) < 1e-10


@pytest.fixture(scope="module")
def graph_runs(problem, tmp_path_factory):
    """``case_graph_path`` on 2 and 4 NCCL ranks (the worlds the cards
    allow), k = 30 and a new k = 12."""
    d, u, v, p, b = problem
    b2 = np.random.default_rng(17).standard_normal(len(b)).astype(np.float32)
    out = {}
    for world in (2, 4):
        if torch.cuda.device_count() >= world:
            out[world] = spawn(world, [("g", "graph_path", dict(
                d=d, u=u, v=v, p=p, b=b, b2=b2, k=30, k2=12))],
                tmp_path_factory.mktemp(f"graph{world}"), device="cuda")
    return out


def _graph_ranks(graph_runs, world):
    if world not in graph_runs:
        pytest.skip(f"needs {world} NVIDIA GPUs")
    return [rank["g"] for rank in graph_runs[world]]


def _bitwise(a, b):
    for key in ("alphas", "betas", "x"):
        assert np.array_equal(a[key], b[key]), key
    assert a["steps"] == b["steps"] and a["b_norm"] == b["b_norm"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_graph_replay_is_bitwise_the_eager_solve_on_cards(
        graph_runs, world, cuda_device):
    """The first solve runs eagerly; the second captures pass one and pass
    two and replays them: α, β, the steps taken, ‖b‖ and the gathered x
    bit for bit the eager solve's, on every rank."""
    ranks = _graph_ranks(graph_runs, world)
    for r in ranks:
        _bitwise(r["again"], r["first"])
        _bitwise(r["first"], ranks[0]["first"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_graph_takes_a_second_b_bitwise_on_cards(graph_runs, world,
                                                        cuda_device):
    for r in _graph_ranks(graph_runs, world):
        _bitwise(r["again2"], r["eager2"])
        assert not np.array_equal(r["again2"]["x"], r["again"]["x"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_graph_a_new_k_captures_a_new_graph_on_cards(
        graph_runs, world, cuda_device):
    for r in _graph_ranks(graph_runs, world):
        # one pair of graphs after the capture, a second for k = 12
        assert r["graphs"] == (1, 2, [(12, 0), (30, 0)])
        _bitwise(r["other_k"], r["eager_k2"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_graph_counts_what_the_eager_solve_counts_on_cards(
        graph_runs, world, cuda_device):
    """LAUNCHES, the collectives and an open log after the capturing
    solve and after a replay equal the eager solve's: 2k − 1 K7 launches
    and 4k + 1 all-gathers with the x gather, the same calls in order."""
    k = 30
    for r in _graph_ranks(graph_runs, world):
        eager, captured, replayed = r["counts"]
        assert eager["launches"] == {"kkt_streaming_matvec": 2 * k - 1}
        assert eager["collectives"]["all-gather"] == 4 * k + 1
        assert len(eager["calls"]) == 4 * k + 1
        for other in (captured, replayed):
            assert other == eager

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_graph_counts_the_fused_step_kernels_on_cards(
        graph_runs, world, cuda_device):
    """The fused step's launches other than K7 (``STEP_KERNELS``) after the
    capturing solve and after a replay equal the eager solve's: four
    kernels a step of pass one, one a step of pass two."""
    k = 30
    for r in _graph_ranks(graph_runs, world):
        eager, captured, replayed = r["counts"]
        assert eager["step_kernels"] == {
            "shard_step_node_fold": k, "shard_step_orthogonalise": k,
            "shard_step_norm": k, "shard_step_advance": k,
            "shard_step_two_nodes": k - 1}
        assert captured["step_kernels"] == eager["step_kernels"]
        assert replayed["step_kernels"] == eager["step_kernels"]


@pytest.fixture(scope="module")
def fused_step_runs(problem, tmp_path_factory):
    """``case_fused_step`` on 1, 2 and 4 NCCL ranks (those the cards
    allow), each beside the same case on as many gloo ranks, where the
    passes are the core scans: ``{world: (card ranks, CPU ranks)}``."""
    d, u, v, p, b = problem
    kwargs = dict(d=d, u=u, v=v, p=p, b=b, k=20, chunk=7,
                  breakdown=breakdown_kkt())
    out = {}
    for world in (1, 2, 4):
        if torch.cuda.device_count() >= world:
            out[world] = tuple(
                spawn(world, [("f", "fused_step", kwargs)],
                      tmp_path_factory.mktemp(f"fused{world}{dev}"),
                      device=dev)
                for dev in ("cuda", "cpu"))
    return out


def _fused_ranks(fused_step_runs, world):
    if world not in fused_step_runs:
        pytest.skip(f"needs {world} NVIDIA GPUs")
    card, cpu = fused_step_runs[world]
    return [(c["f"], h["f"]) for c, h in zip(card, cpu)]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_step_solve_meets_the_scans_and_one_card_on_cards(
        fused_step_runs, world, cuda_device):
    """The fused solve against the core scans on gloo ranks and against one
    card's FusedKKTSolver, at the sharded tests' tolerances; every rank
    holds rank 0's bits, and the replayed solve the eager one's."""
    ranks = _fused_ranks(fused_step_runs, world)
    for card, cpu in ranks:
        _bitwise(card["first"], ranks[0][0]["first"])
        _bitwise(card["again"], card["first"])
        for ref in (cpu["first"], card["one_card"]):
            assert card["first"]["steps"] == ref["steps"] == 20
            np.testing.assert_allclose(card["first"]["alphas"],
                                       ref["alphas"], rtol=2e-4)
            assert _rel(card["first"]["x"], ref["x"]) < 1e-4


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_step_pass_two_replays_the_basis_bitwise_on_cards(
        fused_step_runs, world, cuda_device):
    """Pass two of y = I gives the basis pass's rows back bit for bit, and
    the basis pass's α, β are pass one's."""
    for card, _ in _fused_ranks(fused_step_runs, world):
        assert card["replay"] == (True, True)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_step_chunks_are_the_monolithic_pass_on_cards(
        fused_step_runs, world, cuda_device):
    for card, _ in _fused_ranks(fused_step_runs, world):
        chunked, whole = card["chunked"]
        for key in ("alphas", "betas"):
            assert np.array_equal(chunked[key], whole[key]), key
        assert chunked["steps"] == whole["steps"]
        assert chunked["b_norm"] == whole["b_norm"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_step_zero_b_takes_no_step_on_cards(fused_step_runs, world,
                                                  cuda_device):
    for card, cpu in _fused_ranks(fused_step_runs, world):
        zero = card["zero"]
        assert zero["steps"] == cpu["zero"]["steps"] == 0
        assert not zero["alphas"].any() and not zero["x"].any()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_step_breakdown_inside_a_step_on_cards(fused_step_runs, world,
                                                     cuda_device):
    """The breakdown instance stops after a few steps, as the core scans
    do: the masked steps store zeros, the replay is bitwise the eager
    solve, and x meets the scans'."""
    for card, cpu in _fused_ranks(fused_step_runs, world):
        eager, again = card["breakdown"]
        ref = cpu["breakdown"][0]
        steps = eager["steps"]
        assert steps == ref["steps"] < 20
        assert eager["betas"][steps - 1] == 0.0
        assert not eager["alphas"][steps:].any()
        np.testing.assert_allclose(eager["alphas"], ref["alphas"], rtol=2e-4,
                                   atol=1e-6)
        assert _rel(eager["x"], ref["x"]) < 1e-4
        _bitwise(again, eager)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_step_solves_two_functions_on_cards(fused_step_runs, world,
                                                  cuda_device):
    """f = ("inv", "exp"): x of two rows, the first bit for bit the solve
    of "inv" alone, both within the scans' tolerance."""
    for card, cpu in _fused_ranks(fused_step_runs, world):
        x2, n = card["nf2"]["x"], len(card["first"]["x"])
        assert x2.shape == cpu["nf2"]["x"].shape == (2, n)
        assert np.array_equal(x2[0], card["first"]["x"])
        for row in range(2):
            assert _rel(x2[row], cpu["nf2"]["x"][row]) < 1e-4


@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_gather_kernel_matches_plain_on_card(case, cuda_device):
    rng = np.random.default_rng(6)
    d, u, v, p = CASES[case](rng)
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    x = torch.from_numpy(rng.standard_normal(m + p).astype(np.float32)).to(
        cuda_device)
    hi, lo = two_level(lay.u)
    arcs_of_ent = torch.where(lay.ent >= 0, lay.ent, ~lay.ent)
    forms = [(x[m:], lay.u, None), (x[m:], lay.u.to(torch.int16), None),
             (x[m:], lo, hi), (x[:m], arcs_of_ent, None),
             (x[m:], (lay.u % 256).to(torch.uint8), None)]
    reset_launches()
    calls = 0
    for tab, idx, hi_ in forms:
        for mode in ("smem", "ldg", "plain"):
            g = probe_gather_cuda(tab, idx, hi_, mode)
            calls += 1
            assert torch.equal(g, probe_gather_plain(tab, idx, hi_)), mode
    torch.cuda.synchronize()
    assert LAUNCHES["probe_gather"] == calls


def test_probe_stream_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(7)
    d, u, v, p = CASES["random"](rng, 5003, 300)  # a ragged last block
    dev = cuda_device
    d, u, v = (torch.from_numpy(a).to(dev) for a in (d, u, v))
    x = torch.from_numpy(rng.standard_normal(len(d)).astype(np.float32)).to(dev)
    rec = pack_records(d, u, v, x)
    ref = stream_plain(d, u, v, x)
    reset_launches()
    for threads in (128, 256, 512, 1024):
        for apt in (1, 2, 4, 8):
            assert torch.equal(probe_stream(d, u, v, x, threads, apt), ref)
            assert torch.equal(stream_records(rec, threads, apt), ref)
    torch.cuda.synchronize()
    assert LAUNCHES["probe_stream"] == 32


@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_stages_and_pipeline_match_k7_on_card(case, cuda_device):
    rng = np.random.default_rng(8)
    d, u, v, p = CASES[case](rng)
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    cpu = KKTLayout.build(d, u, v, p, CPU)
    x = torch.from_numpy(rng.standard_normal(m + p).astype(np.float32))
    xd = x.to(cuda_device)
    reset_launches()
    y7 = kkt_shard_matvec_cuda(lay, xd)
    # full and the pipeline are K7, bit for bit
    assert torch.equal(probe_stages_cuda(lay, xd, "full"), y7)
    assert torch.equal(probe_pipeline_cuda(lay, xd), y7)
    bound = _node_bound(lay, xd, torch.finfo(torch.float32).eps).cpu()
    tiny = 1e-30 * torch.arange(m, dtype=torch.float32)
    tiny_bound = _node_bound(cpu, torch.cat([tiny, torch.zeros(p)]),
                             torch.finfo(torch.float32).eps)
    modes = [("full", 0), ("arc_only", 0), ("node_only", 0),
             ("node_no_gather", 0), ("no_gather", 0), ("stream_only", 0),
             ("alu", 5), ("gather", min(3, p - 1))]
    for mode, param in modes:
        y = probe_stages_cuda(lay, xd, mode, param).cpu()
        ref = stages_plain(cpu, x, mode, param)
        assert torch.equal(y[:m], ref[:m]), mode
        nb = tiny_bound if "no_gather" in mode else bound
        assert bool(((y[m:] - ref[m:]).abs() <= nb).all()), mode
    torch.cuda.synchronize()
    assert LAUNCHES["probe_stages"] == 1 + len(modes)
    assert LAUNCHES["probe_pipeline"] == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_stages_full_and_node_sorted_bitwise_k7_on_card(case,
                                                              cuda_device):
    # full is K7's instruction stream; node_sorted walks the signed copy
    # through the identity index, and its y_n is K7's bit for bit (with and
    # without a prebuilt copy), its y_a untouched
    rng = np.random.default_rng(10)
    d, u, v, p = CASES[case](rng)
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    x = torch.from_numpy(rng.standard_normal(m + p).astype(np.float32)).to(
        cuda_device)
    for e in (1.0, 0.5):
        y7 = kkt_shard_matvec_cuda(lay, x, e)
        assert torch.equal(probe_stages_cuda(lay, x, "full", e_scale=e), y7)
        copy = node_sorted_copy(lay, x)
        out = torch.full_like(x, 7.0)
        y = probe_stages_cuda(lay, x, "node_sorted", e_scale=e, out=out,
                              copy=copy)
        assert torch.equal(y[m:], y7[m:]) and bool((y[:m] == 7.0).all())
        assert torch.equal(
            probe_stages_cuda(lay, x, "node_sorted", e_scale=e)[m:], y7[m:])


@functools.lru_cache(maxsize=None)
def _pipeline_problem(m):
    """The headline, or a random instance of m arcs over 300 nodes (m of
    1, 3, 1,023, 1,025 and 4,099: the ragged tiles and tails), and its x."""
    rng = np.random.default_rng(11)
    if m == "headline":
        inst = generate_mcf_instance(500_000, rho=3, instance_id=1)
        d, u, v, p = (inst.quad_costs, inst.arc_u, inst.arc_v,
                      inst.num_nodes)
    else:
        d, u, v, p = CASES["random"](rng, m, 300)
    return d, u, v, p, rng.standard_normal(len(d) + p).astype(np.float32)


@pytest.mark.parametrize("m", [1, 3, 1023, 1025, 4099, "headline"])
def test_probe_pipeline_modes_and_stores_bitwise_k14c_on_card(m,
                                                              cuda_device):
    # every mode with both stores bitwise its K14c twin, full bitwise K7,
    # at e = 1 and 0.5; the arc kernel alone and the serialised launch
    # give the same bits; each call counts one launch
    d, u, v, p, x = _pipeline_problem(m)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    reset_launches()
    calls = 0
    for e in (1.0, 0.5):
        y7 = kkt_shard_matvec_cuda(lay, xd, e)
        for mode, param in PROBE_PIPELINE_MODES:
            twin = probe_stages_cuda(lay, xd, mode, param, e_scale=e)
            for store in PIPELINE_STORES:
                y = probe_pipeline_cuda(lay, xd, e, mode=mode, param=param,
                                        store=store)
                assert torch.equal(y, twin), (mode, param, store, e)
                if mode == "full":
                    assert torch.equal(y, y7), (store, e)
                out = torch.full_like(xd, 7.0)
                y = probe_pipeline_cuda(lay, xd, e, out=out, mode=mode,
                                        param=param, store=store,
                                        nodes=False)
                assert torch.equal(y[:lay.m], twin[:lay.m])
                assert bool((y[lay.m:] == 7.0).all())
                y = probe_pipeline_cuda(lay, xd, e, mode=mode, param=param,
                                        store=store, concurrent=False)
                assert torch.equal(y, twin), (mode, store, "serialised")
                calls += 3
    torch.cuda.synchronize()
    assert LAUNCHES["probe_pipeline"] == calls
    assert LAUNCHES["probe_stages"] == 2 * len(PROBE_PIPELINE_MODES)


@pytest.mark.parametrize("m", [3, 4099, "headline"])
def test_probe_pipeline_ring_shapes_bitwise_k7_on_card(m, cuda_device):
    # every tile, stage count and store of the sweep: full bitwise K7 and
    # arc_only's y_a K7's, y_n untouched; the occupancy query answers
    d, u, v, p, x = _pipeline_problem(m)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    y7 = kkt_shard_matvec_cuda(lay, xd)
    for tile in PIPELINE_TILES:
        for stages in PIPELINE_STAGE_COUNTS:
            for store in PIPELINE_STORES:
                ring = dict(tile=tile, stages=stages, store=store)
                assert torch.equal(probe_pipeline_cuda(lay, xd, **ring), y7)
                out = torch.full_like(xd, 7.0)
                y = probe_pipeline_cuda(lay, xd, arcs_only=True, out=out,
                                        **ring)
                assert torch.equal(y[:lay.m], y7[:lay.m])
                assert bool((y[lay.m:] == 7.0).all())
                per_sm, smem = probe_pipeline_blocks("full", **ring)
                assert per_sm >= 1
                assert smem == 128 + 4 * stages * tile * (
                    4 + (store == "bulk"))


def test_probe_pipeline_fork_replays_in_a_graph_on_card(cuda_device):
    # the forked node kernel is a branch of a captured graph: a replay on
    # new x gives K7's y of the new x
    d, u, v, p, x = _pipeline_problem(4099)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    out = torch.zeros_like(xd)
    probe_pipeline_cuda(lay, xd, out=out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        probe_pipeline_cuda(lay, xd, out=out)
    xd.mul_(-2.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, kkt_shard_matvec_cuda(lay, xd))


def _gather_views(dev, n, off, table):
    """A table, and int32, int16, uint8 and two-level index views of n
    entries starting ``off`` elements into their buffers."""
    rng = np.random.default_rng(n * 7 + off)
    tab = torch.from_numpy(rng.standard_normal(table + 3).astype(
        np.float32)).to(dev)[off % 3:off % 3 + table]
    flat = rng.integers(0, table, n + 4)
    out = {}
    out["int32"] = (torch.from_numpy(flat.astype(np.int32)).to(dev)[
        off:off + n], None)
    if table <= 32767:
        out["int16"] = (torch.from_numpy(flat.astype(np.int16)).to(dev)[
            off:off + n], None)
    if table <= 256:
        out["uint8"] = (torch.from_numpy(flat.astype(np.uint8)).to(dev)[
            off:off + n], None)
    hi, lo = two_level(torch.from_numpy(flat).to(dev))
    out["two_level"] = (lo[off:off + n], hi[off:off + n])
    # the same hi at another phase than lo: every entry scalar
    skew = (off + 1) % 4
    buf = torch.zeros(n + 4, dtype=torch.int16, device=dev)
    buf[skew:skew + n] = hi[off:off + n]
    out["two_level_skew"] = (lo[off:off + n], buf[skew:skew + n])
    return tab, out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 1001, 4099, 70001])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_probe_gather_tiers_bitwise_on_ragged_and_offset_views_on_card(
        n, off, cuda_device):
    # every tier, every index type, ragged lengths (n mod 4 of 0..3) and
    # views at offsets 0..3: bitwise tab[idx]; the cluster tier also on a
    # table past one block's shared memory
    for table in (200, 5000, 200_000):
        tab, views = _gather_views(cuda_device, n, off, table)
        for name, (idx, hi) in views.items():
            for mode in ("smem", "ldg", "plain", "cluster"):
                if mode == "smem" and table > 58_104:
                    continue
                g = probe_gather_cuda(tab, idx, hi, mode)
                assert torch.equal(g, probe_gather_plain(tab, idx, hi)), (
                    table, name, mode)


def test_probe_gather_cluster_shapes_and_stage_only_on_card(cuda_device):
    # the headline's x_a (500,000 floats) goes to 16 slices of 32,768, if
    # the card holds such a cluster; staging alone writes nothing
    tab = torch.randn(500_000, device=cuda_device)
    idx = torch.randint(0, 500_000, (1_000_003,), device=cuda_device,
                        dtype=torch.int32)
    try:
        shape = cluster_shape(tab.numel())
    except ValueError as why:
        assert "resident" in str(why)
        return
    assert (shape["cluster"], shape["slice_entries"]) == (16, 32768)
    assert shape["active_clusters"] >= 1
    reset_launches()
    assert probe_gather_cuda(tab, idx, None, STAGE_ONLY) is None
    assert torch.equal(probe_gather_cuda(tab, idx, None, "cluster"),
                       tab[idx.long()])
    torch.cuda.synchronize()
    assert LAUNCHES["probe_gather"] == 2


def test_probe_runs_check_and_time_on_card(cuda_device):
    rng = np.random.default_rng(9)
    d, u, v, p = CASES["random"](rng, 4000, 300)
    lay = KKTLayout.build(d, u, v, p, cuda_device)
    x = torch.from_numpy(rng.standard_normal(4300).astype(np.float32)).to(
        cuda_device)
    for name in ("stream", "stages", "pipeline"):
        reset_launches()
        recs = probe_run(name, lay, x, reps=5)
        assert recs and all(r["us"] > 0 and r["us_cold"] > 0 for r in recs)
    # the pipeline's checked calls: 7 modes x 2 stores, the 3 ALU chains'
    # arc kernels alone x 2 stores, the 3 x 3 x 2 sweep of full and
    # arc_only, the serialised full; then its timed variants: those 14 +
    # 6 + 36, the default concurrent and serialised; each warm and cold,
    # 3 warm-up calls and 5 calls a replay of the graph
    checked = 7 * 2 + 3 * 2 + 3 * 3 * 2 * 2 + 1
    timed = 7 * 2 + 3 * 2 + 3 * 3 * 2 * 2 + 2
    assert LAUNCHES["probe_pipeline"] == checked + timed * 2 * (
        3 + 5 * PROBE_REPLAYS)
    assert "bound by the" in stage_split(probe_run("stages", lay, x, reps=5))


def test_sharded_sparse_operator_on_a_one_rank_nccl_group_on_card(
        problem, cuda_device, tmp_path):
    d, u, v, p, b = problem
    k = 20
    [rank0] = spawn(1, [("path", "sparse_card_path",
                         dict(d=d, u=u, v=v, p=p, b=b, k=k))],
                    tmp_path, device="cuda")
    r = rank0["path"]
    # one K15 launch a matvec (one rank owns every column, so no remote
    # part) and nothing else; one gather a matvec; the replay bitwise; the
    # generic tier's coefficients
    assert r["remote_nnz"] == 0
    assert {n: c for n, c in r["launches"].items() if c} == {
        "csr_spmv": 2 * k - 1}
    assert r["starts"] == 2 * k - 1 and r["replay"]
    assert r["dec"]["steps"] == r["dec1"]["steps"] == k
    np.testing.assert_allclose(r["dec"]["alphas"], r["dec1"]["alphas"],
                               rtol=1e-4)
    assert _rel(r["x"], r["x1"]) < 1e-4


def test_sharded_sparse_operator_across_four_cards(problem, cuda_device,
                                                   tmp_path):
    """Four NCCL ranks, one card each: every rank holds the same x and α,
    β, within the f32 tolerances of one card's generic solve."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    d, u, v, p, b = problem
    k = 20
    ranks = spawn(4, [("path", "sparse_card_path",
                       dict(d=d, u=u, v=v, p=p, b=b, k=k))],
                  tmp_path, device="cuda")
    for r in (rank["path"] for rank in ranks):
        # K15 for the owned part a matvec, and for the remote part if any
        parts = 2 if r["remote_nnz"] else 1
        assert {n: c for n, c in r["launches"].items() if c} == {
            "csr_spmv": parts * (2 * k - 1)} and r["replay"]
        assert r["starts"] == 2 * k - 1
        assert np.array_equal(r["x"], ranks[0]["path"]["x"])
        assert np.array_equal(r["dec"]["alphas"],
                              ranks[0]["path"]["dec"]["alphas"])
        np.testing.assert_allclose(r["dec"]["alphas"], r["dec1"]["alphas"],
                                   rtol=1e-4)
        assert _rel(r["x"], r["x1"]) < 1e-4


# --- reorthogonalisation and block Lanczos on K8 ----------------------------

def _tf32_runs(fn):
    """``fn()`` with TF32 off, then on (launches counted each time); the
    caller's setting is restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    out = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            reset_launches()
            got = fn()
            torch.cuda.synchronize()
            out.append((got, {n: c for n, c in LAUNCHES.items() if c}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


@pytest.mark.parametrize("mode", ["full", "selective"])
def test_reorth_on_card_runs_k8_and_takes_no_tf32(problem, cuda_device,
                                                  mode):
    """One K8 launch a step and nothing else; the CGS sweeps are GEMVs,
    so the TF32 switch changes no bit; α, β at k = 20 match the CPU f64
    run."""
    from two_pass_lanczos_tpu_torch.solvers import pass_one_reorth
    d, u, v, p, b = problem
    op = make_kkt_operator(d, u, v, p, dtype=torch.float32,
                           device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 40
    (x0, l0), (x1, l1) = _tf32_runs(lambda: solve_fAb(
        op, bt, k=k, f="inv", method="one_pass", reorth=mode))
    assert torch.equal(x0, x1)
    assert l0 == l1 == {"kkt_operator_matvec": k}
    dec, basis = pass_one_reorth(op.matvec, bt, 20, mode)
    op64 = make_kkt_operator(d.astype(np.float64), u, v, p, device=CPU)
    dec64, _ = pass_one_reorth(op64.matvec, torch.from_numpy(
        b.astype(np.float64)), 20, mode)
    np.testing.assert_allclose(dec.alphas.cpu().numpy(),
                               dec64.alphas.numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec.betas.cpu().numpy(),
                               dec64.betas.numpy(), rtol=1e-4)


def test_selective_without_a_sweep_is_the_plain_pass_on_card(cuda_device):
    """A selective run that never sweeps is bitwise the plain one-pass
    pass one on the card too: α, β and every basis row."""
    from two_pass_lanczos_tpu_torch.algorithms.reorth import (
        pass_one_scan_selective,
    )
    d = np.linspace(1.0, 3.0, 500).astype(np.float32)
    op = DiagonalOperator(d, device=cuda_device)
    bt = torch.from_numpy(np.random.default_rng(0).standard_normal(500)
                          .astype(np.float32)).to(cuda_device)
    dec_p, bas_p = pass_one_scan(op.matvec, bt, 8, emit_basis=True)
    dec_s, bas_s, nre = pass_one_scan_selective(op.matvec, bt, 8)
    assert int(nre) == 0
    assert torch.equal(dec_p.alphas, dec_s.alphas)
    assert torch.equal(dec_p.betas, dec_s.betas)
    assert torch.equal(bas_p, bas_s)


@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_block_on_card_runs_p_k8_a_step_and_takes_no_tf32(problem,
                                                          cuda_device,
                                                          method):
    """p K8 launches a block step and pass (every one of the k steps runs
    its matvec, as the masked scan does); the same bits with TF32 on; x
    within 1e-4 of the CPU f64 solve at k = 12."""
    from two_pass_lanczos_tpu_torch import solve_fAb_block
    d, u, v, p, b = problem
    n, width, k = len(d) + p, 3, 12
    op = make_kkt_operator(d, u, v, p, dtype=torch.float32,
                           device=cuda_device)
    bb = np.random.default_rng(3).standard_normal((n, width)).astype(
        np.float32)
    (x0, l0), (x1, l1) = _tf32_runs(lambda: solve_fAb_block(
        op, bb, k, "inv", method=method))
    assert torch.equal(x0, x1)
    passes = 1 if method == "one_pass" else 2
    assert l0 == l1 == {"kkt_operator_matvec": passes * width * k}
    op64 = make_kkt_operator(d.astype(np.float64), u, v, p, device=CPU)
    x64 = solve_fAb_block(op64, bb.astype(np.float64), k, "inv",
                          method=method).numpy()
    assert _rel(x0.cpu().numpy(), x64) < 1e-4


# --- the default device ----------------------------------------------------

@pytest.mark.parametrize("entry", [
    "FusedKKTSolver", "make_kkt_operator", "DiagonalOperator",
    "load_decomposition", "decomposition_from_jax", "DFFusedKKTSolver",
    "DFKKTOperator", "make_mesh", "initialize_distributed", "probes",
    "entry", "dryrun_multichip"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    # with no card, the default device="cuda" raises; it never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = np.ones(3, np.float32)
    calls = {
        "FusedKKTSolver": lambda: FusedKKTSolver(d, [0, 1, 2], [1, 2, 0], 3),
        "make_kkt_operator": lambda: make_kkt_operator(d, [0, 1, 2],
                                                       [1, 2, 0], 3),
        "DiagonalOperator": lambda: DiagonalOperator(d),
        "load_decomposition": lambda: load_decomposition(tmp_path / "x.npz"),
        "decomposition_from_jax": lambda: decomposition_from_jax(None),
        "DFFusedKKTSolver": lambda: DFFusedKKTSolver(d, [0, 1, 2],
                                                     [1, 2, 0], 3),
        "DFKKTOperator": lambda: DFKKTOperator.from_f64(d, [0, 1, 2],
                                                        [1, 2, 0], 3),
        # the sharded solvers' device is their mesh's
        "make_mesh": lambda: make_mesh(),
        "initialize_distributed": lambda: initialize_distributed(
            f"file://{tmp_path / 'store'}", 1, 0),
        # the probes' entry point: the card or nothing
        "probes": lambda: probes_main(["stages", "--arcs", "100"]),
        # the twin of __graft_entry__.py
        "entry": lambda: step_entry(),
        "dryrun_multichip": lambda: dryrun_multichip(1),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
