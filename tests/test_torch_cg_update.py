"""The Jacobi-CG iteration's fused vector update (``ops/cg_update.py``,
``csrc/cg_update.cu``) and where the solvers take it (``solvers/cg.py``).

On the CPU: the solvers choose the kernels only for a Jacobi (``precond is
None``), Fletcher-Reeves solve of CUDA vectors, whose type and diagonal the
kernels check, and count its steps under ``fused_steps``; the plain body is
the CPU's path; the source rounds each operation on its own (the ``_rn``
intrinsics, no fused multiply-add) and uses no atomics; the benchmark's
wrapper map leaves both kernels to plain torch; the
``cg.fused_update_share`` reader on hand-built records. On the card
(``cuda`` marker, skipped without one): the kernels against the plain body,
bitwise, in float32 and float64 on flat, row-layout and batched vectors
with live and frozen lanes, and strided; whole solves in captured chunks; a
CUDA solve the kernels do not take raises; two steps of the structured and
distorted cells at 16 cells per axis, and of the structured one at 32,
whose pressure GMG-CG keeps plain torch.

    python -m pytest --noconftest tests/test_torch_cg_update.py -m cuda
"""

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from poroelasticity_dealii_torch.ops import _cuda  # noqa: E402
from poroelasticity_dealii_torch.ops import cg_update  # noqa: E402
from poroelasticity_dealii_torch.ops import comp_major as cm  # noqa: E402
from poroelasticity_dealii_torch.solvers import cg as tcg  # noqa: E402
from poroelasticity_dealii_torch.utils import profiling  # noqa: E402
from portbench import harness, spans, spec, tracing  # noqa: E402

SOURCE = _cuda._PKG / "csrc" / "cg_update.cu"


@pytest.fixture
def rec(monkeypatch):
    """The process recorder, emptied for the test and restored after it."""
    r = profiling.RECORDER
    for k, v in vars(profiling.Recorder()).items():
        monkeypatch.setattr(r, k, v)
    return r


def _spd(n, seed, dtype=torch.float64, device="cpu"):
    """A dense SPD matrix with a varied diagonal, and its apply on the last
    axis."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    a = torch.as_tensor(m @ m.T + n * np.diag(rng.uniform(1, 4, n)),
                        dtype=dtype, device=device)
    return a, (lambda x: x @ a.T)


# ------------------------------------------------------------ the dispatch

def test_layout_takes_contiguous_float_vectors_with_a_matching_diagonal():
    b = torch.zeros(4, 6, dtype=torch.float64)
    d = torch.ones(4, 6, dtype=torch.float64)
    cg_update.check(b, d, False)
    cg_update.check(b, d[0], True)
    cg_update.check(b.float(), d.float(), False)
    # strided vectors are taken: the update makes them contiguous
    cg_update.check(b.t(), d.t(), False)
    cg_update.check(b, d.t().contiguous().t(), False)
    for args, problem in (((b, d[0], False), "shape"),
                          ((b, d, True), "shape"),         # one lane's
                          ((b, d.float(), False), "float32 diagonal"),
                          ((b.half(), d.half(), False), "float16 vectors")):
        with pytest.raises(ValueError, match=f"do not take.*{problem}"):
            cg_update.check(*args)
    # the CPU takes the plain body, whatever its vectors
    assert tcg._jacobi_update(b.half(), d, False) is tcg._jacobi_update_plain
    assert tcg._jacobi_update(b, d[0], True) is tcg._jacobi_update_plain


def test_check_refuses_vectors_past_the_kernels_int_index():
    b = torch.empty(2 ** 31, dtype=torch.float32, device="meta")
    cg_update.check(b[:-1], b[:-1], False)
    with pytest.raises(ValueError, match=f"{2 ** 31} values"):
        cg_update.check(b, b, False)


def _recording(monkeypatch):
    """Let the solvers take the fused path on the CPU, with the plain body
    standing in for the kernels; the calls are recorded."""
    calls = []

    def fake(*args):
        calls.append(args[0].shape)
        return tcg._jacobi_update_plain(*args)

    monkeypatch.setattr(tcg, "_jacobi_update_cuda", fake)
    monkeypatch.setattr(tcg, "_jacobi_update",
                        lambda b, dinv, batched: tcg._jacobi_update_cuda)
    return calls


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_jacobi_solves_take_the_fused_update_and_count_it(rec, monkeypatch,
                                                          chunk):
    n = 30
    a, apply = _spd(n, chunk)
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(n))
    plain = tcg.cg_solve(apply, b, torch.zeros_like(b), diag=a.diag(),
                         tol=1e-9, max_iter=200, chunk=chunk)
    calls = _recording(monkeypatch)
    with profiling.step():
        res = tcg.cg_solve(apply, b, torch.zeros_like(b), diag=a.diag(),
                           tol=1e-9, max_iter=200, chunk=chunk,
                           graph_key=("site",))
    counts = rec.steps[-1].counts
    assert torch.equal(res.x, plain.x)
    assert int(res.iterations) == int(plain.iterations)
    assert len(calls) == counts["chunk_steps"]["site"] > 0
    assert counts["fused_steps"] == counts["chunk_steps"]


def test_batched_jacobi_solves_take_the_fused_update(rec, monkeypatch):
    n, lanes = 24, 3
    a, apply = _spd(n, 3)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal((lanes, n)))
    tol = torch.tensor([1e-3, 1e-9, 1e-6], dtype=torch.float64)
    plain = tcg.cg_solve_batched(apply, b, torch.zeros_like(b), a.diag(),
                                 tol, 200, chunk=4)
    calls = _recording(monkeypatch)
    with profiling.step():
        res = tcg.cg_solve_batched(apply, b, torch.zeros_like(b), a.diag(),
                                   tol, 200, chunk=4,
                                   graph_key=("projection",))
    counts = rec.steps[-1].counts
    assert torch.equal(res.x, plain.x)
    assert torch.equal(res.iterations, plain.iterations)
    assert calls == [b.shape] * counts["chunk_steps"]["projection"]
    assert counts["fused_steps"] == counts["chunk_steps"]


def test_other_solves_keep_plain_torch(rec, monkeypatch):
    """An operator preconditioner (flexible or not) and Richardson never
    reach the fused update, and count no fused steps."""
    n = 20
    a, apply = _spd(n, 11)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    inv = 1.0 / a.diag()
    calls = _recording(monkeypatch)
    with profiling.step():
        for flexible in (None, False):
            tcg.cg_solve(apply, b, torch.zeros_like(b), tol=1e-9,
                         max_iter=100, precond=lambda r: r * inv,
                         flexible=flexible, graph_key=(f"pc{flexible}",))
        tcg.cg_solve(apply, b, torch.zeros_like(b), diag=a.diag(),
                     tol=1e-9, max_iter=100, flexible=True,
                     graph_key=("flex",))
        tcg.richardson_solve(apply, b, torch.zeros_like(b),
                             lambda r: r * inv, 1e-9, 50,
                             graph_key=("rich",))
    counts = rec.steps[-1].counts
    assert calls == [] and "fused_steps" not in counts
    assert len(counts["chunk_steps"]) == 4


def test_the_cpu_takes_the_plain_body(rec, monkeypatch):
    def fail(*args):
        raise AssertionError("the kernels' path on CPU tensors")

    monkeypatch.setattr(tcg, "_jacobi_update_cuda", fail)
    n = 16
    a, apply = _spd(n, 2)
    b = torch.ones(n, dtype=torch.float64)
    with profiling.step():
        res = tcg.cg_solve(apply, b, torch.zeros_like(b), diag=a.diag(),
                           tol=1e-10, max_iter=100, graph_key=("cpu",))
    assert bool(res.converged)
    assert "fused_steps" not in rec.steps[-1].counts
    assert tcg._jacobi_update(b, a.diag(), False) is tcg._jacobi_update_plain


def test_launches_are_counted_with_the_wrappers():
    assert "cg_update" in cm.LAUNCH_KEYS
    assert "cg_update" in cm.launch_counts()


# ------------------------------------------------------------ the source

def _body(text: str, name: str) -> str:
    """The body of the function ``name`` (from its opening brace to the
    matching one)."""
    start = text.index("{", re.search(r"\b%s\(" % name, text).start())
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start + 1:i]
    raise AssertionError(f"{name}: no closing brace")


def _code() -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", SOURCE.read_text(), flags=re.S)


def test_update_arithmetic_rounds_each_operation_on_its_own():
    code = _code()
    # every operation on a value goes through the three helpers, each an
    # _rn intrinsic in both precisions
    for helper, op in (("mul_rn", "mul"), ("add_rn", "add"),
                       ("sub_rn", "sub")):
        found = re.findall(r"__device__ __forceinline__ (double|float) "
                           r"%s\(\1 a, \1 b\) \{\s*return __(\w)%s_rn\(a, "
                           r"b\);\s*\}" % (helper, op), code)
        assert sorted(found) == [("double", "d"), ("float", "f")], helper
    for element in ("step_element", "direction_element"):
        body = _body(code, element)
        assert not re.search(r"[-+*/]", body.replace("T&", "")), element
        assert set(re.findall(r"\b(\w+)\(", body)) <= {"mul_rn", "add_rn",
                                                        "sub_rn"}, element
    # the kernels compute values through the element functions alone
    assert "step_element(" in _body(code, "cg_jacobi_step_kernel")
    assert "direction_element(" in _body(code, "cg_direction_kernel")
    assert not re.search(r"\bfma\w*|__f?fma|__dfma", code)


def test_source_is_built_and_bound():
    assert SOURCE in _cuda.SOURCES
    assert {"cg_jacobi_step", "cg_direction"} <= set(_cuda._SIGNATURES)
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            _code()).group(1))
    assert threads == cg_update.THREADS


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::cg_jacobi_step_kernel<double, 2>("
    "double const*, double const*, double const*, double const*, double "
    "const*, double const*, bool const*, double*, double*, double*, int)",
    "void (anonymous namespace)::cg_direction_kernel<float, 4>(float "
    "const*, float const*, float const*, bool const*, float*, int)",
    "cg_jacobi_step_kernel<float, 1>", "cg_direction_kernel<double, 1>"])
def test_the_kernels_count_as_plain_torch_in_the_trace(name):
    assert tracing.wrapper(name) is None


# ------------------------------------------------------------ the reader

@dataclasses.dataclass
class _Stats:
    pressure_cg_iterations: int
    mech_cg_iterations: int
    projection_cg_iterations: int


def _share(rec, chunk_steps, fused_steps):
    stats = []
    for i, (chunks, fused) in enumerate(zip(chunk_steps, fused_steps)):
        r = profiling.StepRecord(i + 1, False)
        r.counts = {"chunk_steps": chunks}
        if fused:
            r.counts["fused_steps"] = fused
        r.cg = dict(zip(spans.CG_FIELDS, (3, 10, 20)))
        rec.steps.append(r)
        stats.append(_Stats(3, 10, 20))
    reader = spec.load_module(
        ROOT / "portbench" / "metrics" / "cg.fused_update_share.py",
        "test_cg_update_fused_update_share")
    return reader.read(harness.Context(stats))


def test_fused_update_share_reader(rec, monkeypatch):
    every = {"mechanics": 16, "pressure": 4, "projection": 24}
    assert _share(rec, [every] * 2, [every] * 2) == pytest.approx(100.0)
    rec.steps.clear()
    mixed = {"mechanics": 16, "projection": 24}
    assert _share(rec, [every, every], [mixed, {}]) == pytest.approx(
        100.0 * 40 / 88)
    rec.steps.clear()
    assert _share(rec, [every], [{}]) == 0.0
    # a program without the fused update reads nothing
    monkeypatch.setattr("importlib.util.find_spec", lambda name: None)
    rec.steps.clear()
    assert _share(rec, [every], [every]) is None


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def _vectors(shape, dtype, device, seed, offset=0):
    """x, r, p, ap, dinv of ``shape`` (dinv one lane's for a batch given
    as (lanes, n)); ``offset`` values into a larger buffer, so that the
    views miss the 16-byte packs' alignment."""
    g = torch.Generator().manual_seed(seed)
    numel = int(np.prod(shape))

    def vec(scale=1.0):
        t = torch.randn(numel + offset, generator=g, dtype=torch.float64)
        return (t * scale).to(dtype).to(device)[offset:].view(shape)
    return vec(), vec(), vec(), vec(1e3), vec().abs() + 0.5


def _check(shape, lanes, dtype, dev, seed, active, offset=0):
    x, r, p, ap, d = _vectors(shape, dtype, dev, seed, offset)
    if lanes:
        d = d.reshape(lanes, -1)[0].contiguous()
        dot, norm = tcg.LocalReductions.lane_dot, tcg.lane_norm
    else:
        dot, norm = tcg.LocalReductions.dot, torch.linalg.norm
    rz = dot(r, r * d)
    rnorm = norm(r)
    active = torch.as_tensor(active, device=dev)
    a = tcg._jacobi_update_plain(x, r, p, ap, rz, rnorm, d, active, dot,
                                 norm)
    b = tcg._jacobi_update_cuda(x, r, p, ap, rz, rnorm, d, active, dot, norm)
    for u, v, name in zip(a, b, ("x", "r", "p", "rz", "rnorm")):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.equal(u, v), name
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(1_594_323,), (984, 1792), (1001,)])
@pytest.mark.parametrize("live", [True, False])
def test_fused_update_is_bitwise_the_plain_body(cuda_dev, dtype, shape,
                                                live):
    a = _check(shape, 0, dtype, cuda_dev, 1, live)
    x = _vectors(shape, dtype, cuda_dev, 1)[0]
    if not live:
        assert torch.equal(a[0], x)
    # views off the 16-byte alignment take one value a thread
    _check(shape, 0, dtype, cuda_dev, 2, live, offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes,n", [(3, 68_921), (6, 68_921), (6, 1024),
                                     (3, 7)])
def test_batched_fused_update_is_bitwise_the_plain_body(cuda_dev, dtype,
                                                        lanes, n):
    for active in ([True] * lanes, [False] * lanes,
                   [i % 2 == 0 for i in range(lanes)]):
        _check((lanes, n), lanes, dtype, cuda_dev, lanes + n, active)
    _check((lanes, n), lanes, dtype, cuda_dev, 3, [True] * lanes, offset=2)


def _plain_dispatch(monkeypatch):
    monkeypatch.setattr(tcg, "_jacobi_update",
                        lambda b, dinv, batched: tcg._jacobi_update_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_solves_equal_the_plain_body(cuda_dev, dtype, rec,
                                              monkeypatch):
    from poroelasticity_dealii_torch.solvers.cuda_graphs import ChunkGraphs
    n = 512
    a, apply = _spd(n, 4, dtype, cuda_dev)
    g = torch.Generator().manual_seed(9)
    b = torch.randn(n, generator=g, dtype=torch.float64).to(dtype).to(
        cuda_dev)
    bb = torch.randn(6, n, generator=g, dtype=torch.float64).to(dtype).to(
        cuda_dev)
    tol = torch.tensor([1e-2, 1e-4, 1e-5, 1e-3, 1e-5, 1e-1],
                       dtype=torch.float64) * float(bb.norm())
    runs = []
    for plain in (False, True):
        if plain:
            _plain_dispatch(monkeypatch)
        graphs = ChunkGraphs()
        cm.reset_launch_counts()
        with profiling.step():
            out = [tcg.cg_solve(apply, b, torch.zeros_like(b),
                                diag=a.diag(), tol=1e-5 * float(b.norm()),
                                max_iter=300, chunk=8, graphs=graphs,
                                graph_key=("mechanics",)),
                   tcg.cg_solve_batched(apply, bb, torch.zeros_like(bb),
                                        a.diag(), tol, 300, chunk=8,
                                        graphs=graphs,
                                        graph_key=("projection",))]
        torch.cuda.synchronize()
        # a chunk graph's capture runs one step eagerly first
        warm = sum(len(site.graphs) - 1 for site in graphs._sites.values())
        runs.append((out, rec.steps[-1].counts,
                     cm.launch_counts()["cg_update"], warm))
    (fused, counts, launches, warm), (plain, counts_plain, none, _) = runs
    for u, v in zip(fused, plain):
        assert torch.equal(u.x, v.x)
        assert torch.equal(u.iterations, v.iterations)
        assert torch.equal(u.residual_norm, v.residual_norm)
    assert counts["chunk_steps"] == counts_plain["chunk_steps"]
    assert counts["fused_steps"] == counts["chunk_steps"]
    assert "fused_steps" not in counts_plain
    # two launches a fused iteration, replays included
    assert launches == 2 * (sum(counts["chunk_steps"].values()) + warm)
    assert none == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_strided_vectors_run_the_kernels(cuda_dev, dtype, rec, monkeypatch):
    """A strided right-hand side and diagonal take the kernels (made
    contiguous), bitwise the plain body on the same inputs."""
    x, r, p, ap, d = _vectors((1001,), dtype, cuda_dev, 4)
    dot, norm = tcg.LocalReductions.dot, torch.linalg.norm
    d_strided = torch.stack([d, 2 * d], 1)[:, 0]
    assert not d_strided.is_contiguous()
    args = (x, r, p, ap, dot(r, r * d), norm(r), d_strided,
            torch.tensor(True, device=cuda_dev), dot, norm)
    for u, v in zip(tcg._jacobi_update_plain(*args),
                    tcg._jacobi_update_cuda(*args)):
        assert torch.equal(u, v)
    n = 512
    a, apply = _spd(n, 6, dtype, cuda_dev)
    g = torch.Generator().manual_seed(12)
    b = torch.randn(2 * n, generator=g, dtype=torch.float64).to(dtype).to(
        cuda_dev)[::2]
    diag = a.diagonal()                     # a view: stride n + 1
    assert not b.is_contiguous() and not diag.is_contiguous()
    runs = []
    for plain in (False, True):
        if plain:
            _plain_dispatch(monkeypatch)
        cm.reset_launch_counts()
        with profiling.step():
            res = tcg.cg_solve(apply, b, torch.zeros_like(b), diag=diag,
                               tol=1e-5 * float(b.norm()), max_iter=300,
                               chunk=8, graph_key=("mechanics",))
        torch.cuda.synchronize()
        runs.append((res, rec.steps[-1].counts,
                     cm.launch_counts()["cg_update"]))
    (fused, counts, launches), (plain, counts_plain, none) = runs
    assert torch.equal(fused.x, plain.x)
    assert torch.equal(fused.iterations, plain.iterations)
    assert counts["fused_steps"] == counts["chunk_steps"]
    # eager chunks: two launches a step
    assert launches == 2 * counts["chunk_steps"]["mechanics"] > 0
    assert none == 0 and "fused_steps" not in counts_plain


@pytest.mark.cuda
def test_cuda_solves_refuse_what_the_kernels_do_not_take(cuda_dev):
    """A Jacobi solve on the card never falls back to plain torch: vectors
    the kernels do not take raise."""
    n = 64
    a, apply = _spd(n, 8, torch.float32, cuda_dev)
    b = torch.ones(n, dtype=torch.float32, device=cuda_dev)
    with pytest.raises(ValueError, match="float64 diagonal"):
        tcg.cg_solve(apply, b, torch.zeros_like(b), diag=a.diag().double(),
                     tol=1e-5, max_iter=10)
    bb = torch.ones(3, n, dtype=torch.float32, device=cuda_dev)
    with pytest.raises(ValueError, match="shape"):
        tcg.cg_solve_batched(apply, bb, torch.zeros_like(bb),
                             a.diag().expand(3, n), torch.ones(3), 10)
    with pytest.raises(ValueError, match="float16 vectors"):
        tcg._jacobi_update(b.half(), b.half(), False)


def _system(workload, n, device):
    cell = spec.load(ROOT, workload)
    cell.config["cells_per_axis"] = n
    inp = harness.prepare(cell, 2 ** 31 + 5)
    return cell.system().build(cell.config, inp.deck, torch.device(device))


@pytest.mark.cuda
@pytest.mark.parametrize("workload,n,gmg", [("rows40-hold", 16, False),
                                            ("distorted40-hold", 16, False),
                                            ("rows40-hold", 32, True)])
def test_a_cube_step_equals_the_plain_body(cuda_dev, workload, n, gmg, rec,
                                           monkeypatch):
    """Two steps of the cell at ``n`` cells per axis; from 32 the structured
    pressure solve is GMG-CG (``gmg``), which keeps plain torch."""
    runs = []
    for plain in (False, True):
        if plain:
            _plain_dispatch(monkeypatch)
        system = _system(workload, n, cuda_dev)
        st = system.solver.initial_state()
        stats = []
        for k in range(2):
            st, s = system.solver.time_step(st, system.dt, want_u=k == 1)
            stats.append(s)
        torch.cuda.synchronize()
        runs.append((st, stats, rec.steps[-1].counts))
        del system
    (a, sa, ca), (b, sb, cb) = runs
    for x, y in zip(sa, sb):
        for f in dataclasses.fields(x):
            assert np.array_equal(getattr(x, f.name), getattr(y, f.name)), \
                f.name
    for f in ("p", "u", "eps_v", "strains"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert ca["chunk_steps"] == cb["chunk_steps"]
    assert "fused_steps" not in cb
    jacobi = {k: v for k, v in ca["chunk_steps"].items()
              if not (gmg and k == "pressure")}
    assert ca["fused_steps"] == jacobi
    assert {"mechanics", "pressure", "projection"} <= set(ca["chunk_steps"])
