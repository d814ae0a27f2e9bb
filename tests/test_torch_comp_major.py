"""Plain twins of the row-layout kernels against the JAX package: the
interpret-mode Pallas kernels in float32 and the jnp index-math oracles in
float64.  (The CUDA kernels themselves are held against these twins in
tests/test_torch_kernels.py and chip_smoke.py, on the card.)"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.ops import pallas_comp_major as jcm  # noqa: E402
from poroelasticity_dealii_tpu.solvers.structured import \
    build_grid_discretization as jbuild  # noqa: E402

from poroelasticity_dealii_torch.ops import comp_major as cm  # noqa: E402

DECK = "configs/consolidation_3d.data"


def _setup(n):
    d = jbuild(read_input_file(DECK), cells_per_axis=n, multigrid="off",
               elasticity_backend="pallas")
    return d, np.asarray(d.free_mask_u)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n,tc", [(4, 2), (5, 2), (4, 4), (6, 3)])
def test_three_modes_match_pallas_interpret_f32(n, tc):
    """UNMASKED == _kernel_v2, CONSTRAINED == _kernel_v3, FREE == _kernel_v4
    (interpret mode), float32 to 1e-6, including tail slabs (n % tc != 0)."""
    d, free = _setup(n)
    Ke = d.element_ke
    rng = np.random.default_rng(n)
    u = rng.standard_normal(d.n_udofs).astype(np.float32)
    m_np = jcm.to_rows_np(free, n).astype(np.float32)
    R = jcm.to_rows(jnp.asarray(u), n)
    Rf = R * m_np                                   # free-subspace input
    ref_un = jcm.make_pallas_apply_rows(Ke, n, jnp.float32, tc=tc,
                                        interpret=True)(R)
    ref_co = jcm.make_pallas_constrained_apply(Ke, n, m_np, jnp.float32,
                                               tc=tc, interpret=True)(R)
    ref_fr = jcm.make_pallas_free_apply(Ke, n, m_np, jnp.float32, tc=tc,
                                        interpret=True)(Rf)
    K = torch.as_tensor(Ke, dtype=torch.float32)
    x = torch.as_tensor(np.array(R))
    xf = torch.as_tensor(np.array(Rf))
    m = torch.as_tensor(m_np)
    got_un = cm.elasticity_rows_apply(x, None, K, n, cm.UNMASKED)
    got_co = cm.elasticity_rows_apply(x, m, K, n, cm.CONSTRAINED)
    got_fr = cm.elasticity_rows_apply(xf, m, K, n, cm.FREE)
    assert _rel(got_un, ref_un) < 1e-6
    assert _rel(got_co, ref_co) < 1e-6
    assert _rel(got_fr, ref_fr) < 1e-6
    # zero in the padding; zero in -> zero out
    assert not got_un.numpy()[:, (n + 1) ** 2:].any()
    zero = torch.zeros_like(x)
    assert not cm.elasticity_rows_apply(zero, None, K, n, cm.UNMASKED).any()
    # FREE == CONSTRAINED on the free subspace
    np.testing.assert_allclose(
        cm.elasticity_rows_apply(xf, m, K, n, cm.CONSTRAINED).numpy(),
        got_fr.numpy(), rtol=0, atol=1e-6 * float(got_fr.abs().max()))


@pytest.mark.parametrize("n", [2, 3, 5])
def test_apply_matches_reference_apply_f64(n):
    d, _ = _setup(n)
    rng = np.random.default_rng(n)
    u = rng.standard_normal(d.n_udofs)
    ref = np.asarray(jcm.make_reference_apply(d.element_ke, n,
                                              jnp.float64)(jnp.asarray(u)))
    R = cm.to_rows(torch.as_tensor(u), n)
    got = cm.from_rows(cm.elasticity_rows_apply(
        R, None, torch.as_tensor(d.element_ke), n, cm.UNMASKED), n)
    assert _rel(got, ref) < 1e-12


@pytest.mark.parametrize("n", [2, 3, 5])
def test_coupling_rows_matches_oracle_f64(n):
    d, _ = _setup(n)
    p = np.random.default_rng(n).standard_normal(d.n_pdofs)
    ref = jcm.make_coupling_rows(d.element_ce, n, jnp.float64)(
        jnp.asarray(p))
    got = cm.coupling_rows(torch.as_tensor(p),
                           torch.as_tensor(d.element_ce), n)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-10


@pytest.mark.parametrize("n", [2, 3, 5])
def test_projection_rows_matches_oracle_f64(n):
    d, _ = _setup(n)
    u = np.random.default_rng(n).standard_normal(d.n_udofs)
    ref = jcm.make_projection_rows(d.element_pe, n, jnp.float64)(
        jcm.to_rows(jnp.asarray(u), n))
    got = cm.projection_rows(cm.to_rows(torch.as_tensor(u), n),
                             torch.as_tensor(d.element_pe), n)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-10


@pytest.mark.parametrize("n", [4, 9, 10])
def test_coupling_rows_matches_pallas_interpret_f32(n):
    """coupling_rows == _kernel_coupling (interpret mode), float32 to 1e-6;
    the Pallas kernel forces tc = 8 from n = 8 on, so n = 9 and 10 end in a
    tail slab (n % tc != 0)."""
    d, _ = _setup(n)
    p = np.random.default_rng(n).standard_normal(d.n_pdofs).astype(
        np.float32)
    ref = jcm.make_coupling_rows_pallas(d.element_ce, n, jnp.float32,
                                        interpret=True)(jnp.asarray(p))
    got = cm.coupling_rows(torch.as_tensor(p), torch.as_tensor(
        d.element_ce, dtype=torch.float32), n)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-6


@pytest.mark.parametrize("n,tc", [(4, 2), (5, 2), (6, 4), (5, 5)])
def test_projection_rows_matches_pallas_interpret_f32(n, tc):
    """projection_rows == _kernel_projection (interpret mode), float32 to
    1e-6, including tail slabs (n % tc != 0)."""
    d, _ = _setup(n)
    u = np.random.default_rng(n).standard_normal(d.n_udofs).astype(
        np.float32)
    R = jcm.to_rows(jnp.asarray(u), n)
    ref = jcm.make_projection_rows_pallas(d.element_pe, n, jnp.float32,
                                          tc=tc, interpret=True)(R)
    got = cm.projection_rows(torch.as_tensor(np.array(R)), torch.as_tensor(
        d.element_pe, dtype=torch.float32), n)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-6


def test_row_ops_route_and_counters_on_cpu():
    """On CPU tensors every wrapper takes its plain twin and counts no
    kernel launch; plain=True gives the same operators."""
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    data = read_input_file(DECK)
    ro = build_grid_discretization(data, cells_per_axis=3,
                                   device="cpu").row_ops
    rop = build_grid_discretization(data, cells_per_axis=3, device="cpu",
                                    kernels="plain").row_ops
    assert rop.plain and not ro.plain
    cm.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = ro.to_rows(torch.as_tensor(rng.standard_normal(3 * 7 ** 3)))
    p = torch.as_tensor(rng.standard_normal(4 ** 3))
    for f in ("apply_rows", "constrained_apply", "free_apply",
              "projection_rows"):
        assert torch.equal(getattr(ro, f)(x), getattr(rop, f)(x))
    assert torch.equal(ro.coupling_rows(p), rop.coupling_rows(p))
    assert list(cm.launch_counts().values()) == [0] * len(cm.LAUNCH_KEYS)
    with pytest.raises(ValueError):
        cm.elasticity_rows_apply(x.to("meta"), None, ro.ke.to("meta"), 3,
                                 cm.UNMASKED)
