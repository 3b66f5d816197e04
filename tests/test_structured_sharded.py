"""Row-sharded structured fast path must reproduce the global structured
rollout exactly (8 virtual devices; slab halos + ppermute rotations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.structured import StructuredModel
from mpas_ocean.structured.model import structured_run_loop
from mpas_ocean.structured.sharded import ShardedStructuredModel

NX = NY = 16
K = 3


@pytest.fixture(scope="module")
def setup():
    horz = planar_hex_mesh(NX, NY, 1000.0, f0=1e-4, beta=1e-11)
    vert = make_vertical_mesh(
        horz, n_vert_levels=K, resting_thickness=np.full((horz.n_cells, K), 10.0)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    sm = StructuredModel(mesh, NX, NY)
    rng = np.random.default_rng(5)
    h = np.full((horz.n_cells, K), 10.0) + 0.01 * rng.normal(size=(horz.n_cells, K))
    u = 0.01 * rng.normal(size=(horz.n_edges, K))
    ssh = h.sum(1) - np.asarray(vert.resting_thickness_sum)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return sm, sm.to_struct(prog)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_structured_matches_global(setup, n_devices):
    sm, st = setup
    n = 7
    ref = structured_run_loop(st, sm.struct_mesh, 10.0, n)

    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:n_devices])
    local = ssm.run(ssm.scatter(st), 10.0, n)
    out = ssm.gather(local)

    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness),
        np.asarray(ref.layer_thickness),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-13,
    )


def test_indivisible_rows_raise(setup):
    sm, _ = setup
    with pytest.raises(ValueError, match="divisible"):
        ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:3])


def test_sharded_structured_overlap_masked_channel():
    """Overlapped slab stepping (boundary strips -> ppermutes -> interior)
    combined with the wall mask: equal to the serial schedule to roundoff
    (XLA may contract mul+add into FMA differently between the two
    programs — 1 ulp) and to the global masked rollout (2 devices so
    rows >= 3 activates overlap)."""
    from mpas_ocean.mesh.cull import cull_cells

    dc = 1000.0
    horz = planar_hex_mesh(NX, NY, dc, f0=1e-4)
    y = np.asarray(horz.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = cull_cells(horz, keep)
    vert = make_vertical_mesh(
        chan, n_vert_levels=K, resting_thickness=np.full((chan.n_cells, K), 10.0)
    )
    mesh = Mesh(horz=chan, vert=vert).to_device()
    sm = StructuredModel(mesh, NX, NY, parent_horz=horz, keep_cells=keep)
    rng = np.random.default_rng(6)
    h = np.full((chan.n_cells, K), 10.0) + 0.01 * rng.normal(size=(chan.n_cells, K))
    u = 0.01 * rng.normal(size=(chan.n_edges, K))
    u *= np.asarray(chan.edges.edge_mask)[:, None]
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    st = sm.to_struct(prog)
    n = 6
    ref = structured_run_loop(st, sm.struct_mesh, 10.0, n)
    devs = jax.devices()[:2]
    a = ShardedStructuredModel(sm.struct_mesh, devices=devs, overlap=True)
    assert a.rows >= 3  # overlap path active
    b = ShardedStructuredModel(sm.struct_mesh, devices=devs, overlap=False)
    out_a = a.gather(a.run(a.scatter(st), 10.0, n))
    out_b = b.gather(b.run(b.scatter(st), 10.0, n))
    for x, y_ in zip(jax.tree.leaves(out_a), jax.tree.leaves(out_b)):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y_), rtol=0, atol=1e-14
        )
    np.testing.assert_allclose(
        np.asarray(out_a.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out_a.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_structured_nonlinear_matches_global(setup, n_devices):
    """Nonlinear (vector-invariant) slab stepping: the derived-field
    exchange round (flux / KE / edge PV) keeps the 1-ring halo exact where
    the raw chained stencil would need two rings — sharded == global at
    f64 roundoff."""
    sm, st = setup
    n = 7
    ref = structured_run_loop(st, sm.struct_mesh, 10.0, n, nonlinear=True)

    ssm = ShardedStructuredModel(
        sm.struct_mesh, devices=jax.devices()[:n_devices]
    )
    local = ssm.run(ssm.scatter(st), 10.0, n, nonlinear=True)
    out = ssm.gather(local)

    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness),
        np.asarray(ref.layer_thickness),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-13,
    )


def test_sharded_structured_nonlinear_masked_runs():
    """Wall-masked nonlinear slab runs now work (masked vertex constants
    ride the stacked f_vertex slab); a mesh stripped of those constants
    still refuses with a helpful error."""
    from mpas_ocean.mesh.cull import cull_cells
    from mpas_ocean.structured.model import structured_run_loop as srl

    dc = 1000.0
    horz = planar_hex_mesh(NX, NY, dc, f0=1e-4)
    y = np.asarray(horz.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = cull_cells(horz, keep)
    vert = make_vertical_mesh(
        chan, n_vert_levels=K,
        resting_thickness=np.full((chan.n_cells, K), 10.0),
    )
    mesh = Mesh(horz=chan, vert=vert).to_device()
    sm = StructuredModel(mesh, NX, NY, parent_horz=horz, keep_cells=keep)
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:2])
    rng = np.random.default_rng(4)
    h = np.full((chan.n_cells, K), 10.0) + 0.01 * rng.normal(
        size=(chan.n_cells, K)
    )
    u = 0.01 * rng.normal(size=(chan.n_edges, K))
    u *= np.asarray(chan.edges.edge_mask)[:, None]
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    st = sm.to_struct(prog)
    ref = srl(st, sm.struct_mesh, 10.0, 4, nonlinear=True)
    out = ssm.gather(ssm.run(ssm.scatter(st), 10.0, 4, nonlinear=True))
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), np.asarray(ref.normal_velocity),
        rtol=0, atol=1e-13,
    )
    stripped = sm.struct_mesh.replace(vertex_kite_planes=None,
                                      vertex_mask=None)
    ssm2 = ShardedStructuredModel(stripped, devices=jax.devices()[:2])
    with pytest.raises(NotImplementedError, match="masked vertex"):
        ssm2.run(ssm2.scatter(st), 10.0, 2, nonlinear=True)


@pytest.mark.parametrize(
    "n_devices,q", [(2, 1), (2, 3), (2, 4), (4, 2), (8, 1)],
)
def test_sharded_pallas_matches_global(setup, n_devices, q):
    """Communication-avoiding superstep path (one ppermute pair of q halo
    rows, then q steps on the halo-extended slab) == global roll rollout
    at f64 roundoff, including q = rows/device (the whole slab as halo)."""
    sm, st = setup
    n = 12 if q == 4 else 6
    ref = structured_run_loop(st, sm.struct_mesh, 10.0, n)

    ssm = ShardedStructuredModel(
        sm.struct_mesh, devices=jax.devices()[:n_devices]
    )
    local = ssm.run_superstep(ssm.scatter(st), 10.0, n, q=q)
    out = ssm.gather(local)

    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness),
        np.asarray(ref.layer_thickness),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-13,
    )


def test_sharded_pallas_masked_forced():
    """Superstep path on a wall-masked channel with momentum forcing (wind
    + both drags + Rayleigh): matches the global forced masked rollout at
    f64 roundoff. Wind and level masks ride q-halo constant slabs."""
    from mpas_ocean.mesh.cull import cull_cells
    from mpas_ocean.models.forcing import make_forcing
    from mpas_ocean.structured import StructuredModel

    dc = 1000.0
    horz = planar_hex_mesh(NX, NY, dc, f0=1e-4)
    y = np.asarray(horz.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = cull_cells(horz, keep)
    vert = make_vertical_mesh(
        chan, n_vert_levels=K,
        resting_thickness=np.full((chan.n_cells, K), 10.0),
    )
    mesh = Mesh(horz=chan, vert=vert).to_device()
    sm = StructuredModel(mesh, NX, NY, parent_horz=horz, keep_cells=keep)
    forcing = make_forcing(
        mesh, wind_stress_zonal=0.1, bottom_drag_linear=1e-4,
        bottom_drag_quadratic=2e-3, rayleigh=1e-5,
    )
    sf = sm.to_struct_forcing(forcing)
    rng = np.random.default_rng(8)
    h = np.full((chan.n_cells, K), 10.0) + 0.01 * rng.normal(
        size=(chan.n_cells, K)
    )
    u = 0.01 * rng.normal(size=(chan.n_edges, K))
    u *= np.asarray(chan.edges.edge_mask)[:, None]
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    st = sm.to_struct(prog)
    n = 6
    ref = structured_run_loop(st, sm.struct_mesh, 10.0, n, forcing=sf)
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:2])
    out = ssm.gather(
        ssm.run_superstep(ssm.scatter(st), 10.0, n, q=3, forcing=sf)
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )


def test_sharded_pallas_tracers_strat(hex16):
    """Superstep path with two active tracers AND layered stratification:
    tracer planes ride the same q-row halos, the Montgomery matmul runs
    per window step — matches the global rollout at f64 roundoff."""
    from mpas_ocean.models.shallow_water import update_ssh
    from mpas_ocean.models.stratification import make_stratification
    from mpas_ocean.models.tracers import make_tracers
    from mpas_ocean.structured import StructuredModel

    vert = make_vertical_mesh(hex16, n_vert_levels=K)
    mesh = Mesh(horz=hex16, vert=vert).to_device()
    rng = np.random.default_rng(9)
    nc, ne = hex16.n_cells, hex16.n_edges
    h0 = np.asarray(vert.resting_thickness) + 0.1 * rng.standard_normal(
        (nc, K)
    )
    u0 = 0.1 * rng.standard_normal((ne, K))
    x = np.asarray(hex16.cells.x)
    tr = make_tracers(
        mesh,
        [10.0 + np.sin(2 * np.pi * x / (x.max() + 1)), 35.0 + 0.0 * x],
    )
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h0), mesh),
        layer_thickness=jnp.asarray(h0),
        normal_velocity=jnp.asarray(u0),
        tracers=tr,
    )
    strat = make_stratification([1024.0, 1025.5, 1026.0])
    sm = StructuredModel(mesh, 16, 16)
    st = sm.to_struct(prog)
    n = 6
    ref = structured_run_loop(
        st, sm.struct_mesh, 10.0, n, tracer_kappa=5.0, strat=strat
    )
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:4])
    out = ssm.gather(
        ssm.run_superstep(
            ssm.scatter(st), 10.0, n, q=2, tracer_kappa=5.0, strat=strat
        )
    )
    np.testing.assert_allclose(
        np.asarray(out.tracers), np.asarray(ref.tracers), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )


@pytest.mark.parametrize("n_devices,q", [(2, 1), (2, 2), (4, 2), (8, 0)])
def test_sharded_pallas_nonlinear_matches_global(setup, n_devices, q):
    """Superstep path with the NONLINEAR vector-invariant step: one
    ppermute pair of 2q halo rows (the PV-flux stencil reaches 2 rows per
    step, recomputed locally), then q steps — must match the global
    nonlinear roll rollout at f64 roundoff."""
    sm, st = setup
    # deeper water for a stable nonlinear perturbation
    from mpas_ocean.structured.model import StructState

    h = st.layer_thickness + 90.0
    st = StructState(
        ssh=h.sum(-1) - sm.struct_mesh.resting_thickness_sum,
        layer_thickness=h, normal_velocity=st.normal_velocity,
    )
    ssm = ShardedStructuredModel(
        sm.struct_mesh, devices=jax.devices()[:n_devices]
    )
    if q == 0:
        # 8 devices on ny2=8 leaves one row per device: the 2-row nonlinear
        # reach cannot be covered by a one-neighbor halo exchange
        with pytest.raises(ValueError, match="rows per device"):
            ssm.run_superstep(ssm.scatter(st), 5.0, 6, nonlinear=True)
        return
    n = 6
    ref = structured_run_loop(st, sm.struct_mesh, 5.0, n, nonlinear=True)
    out = ssm.gather(
        ssm.run_superstep(ssm.scatter(st), 5.0, n, q=q, nonlinear=True)
    )
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-13,
    )


@pytest.mark.parametrize("n_devices,q", [(2, 2), (4, 1)])
def test_sharded_pallas_forward_backward_matches_global(setup, n_devices, q):
    """Superstep path with the forward-backward stepper (reach 2)."""
    sm, st = setup
    n = 6
    ref = structured_run_loop(st, sm.struct_mesh, 10.0, n, fb=True)
    ssm = ShardedStructuredModel(
        sm.struct_mesh, devices=jax.devices()[:n_devices]
    )
    out = ssm.gather(
        ssm.run_superstep(ssm.scatter(st), 10.0, n, q=q, fb=True)
    )
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-13,
    )


@pytest.mark.parametrize("n_devices,q", [(2, 1)])
def test_sharded_pallas_nonlinear_fb_matches_global(setup, n_devices, q):
    """Superstep path with NONLINEAR + FORWARD-BACKWARD (reach 3: the
    fresh-thickness pressure on top of the locally recomputed derived
    fields) — the last stepper x physics combination, previously fenced."""
    sm, st = setup
    from mpas_ocean.structured.model import StructState

    h = st.layer_thickness + 90.0
    st = StructState(
        ssh=h.sum(-1) - sm.struct_mesh.resting_thickness_sum,
        layer_thickness=h, normal_velocity=st.normal_velocity,
    )
    n = 6
    ref = structured_run_loop(st, sm.struct_mesh, 5.0, n, nonlinear=True,
                              fb=True)
    ssm = ShardedStructuredModel(
        sm.struct_mesh, devices=jax.devices()[:n_devices]
    )
    out = ssm.gather(
        ssm.run_superstep(ssm.scatter(st), 5.0, n, q=q, nonlinear=True,
                          fb=True)
    )
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-13,
    )


def test_sharded_pallas_warns_on_reduced_q(setup):
    """An explicitly requested superstep q that cannot be honored
    (indivisible n_steps / halo limit) must warn, not silently shrink."""
    sm, st = setup
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:2])
    with pytest.warns(UserWarning, match="reduced the requested superstep"):
        ssm.run_superstep(ssm.scatter(st), 10.0, 6, q=4)  # 4 does not divide 6


@pytest.mark.parametrize("nonlinear", [False, True])
def test_sharded_objective_grad_matches_global(setup, nonlinear):
    """Differentiable sharded fast path: jax.grad through
    ShardedStructuredModel.objective (checkpointed scan of the slab bodies,
    ppermute transposed to ppermute) must equal the global rollout's
    gradient at f64 roundoff. `gather` of the gradient dict reassembles the
    global gradient because the input halo rows carry zero cotangent."""
    sm, st = setup
    from mpas_ocean.structured.model import StructState

    if nonlinear:
        h = st.layer_thickness + 90.0
        st = StructState(
            ssh=h.sum(-1) - sm.struct_mesh.resting_thickness_sum,
            layer_thickness=h, normal_velocity=st.normal_velocity,
        )
    n, dt = 6, 5.0

    def gobj(s):
        out = structured_run_loop(s, sm.struct_mesh, dt, n,
                                  nonlinear=nonlinear)
        return jnp.sum(out.ssh ** 2)

    gref = jax.grad(gobj)(st)
    oref = gobj(st)
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:4])
    local = ssm.scatter(st)
    o = ssm.objective(local, dt, n, nonlinear=nonlinear)
    np.testing.assert_allclose(float(o), float(oref), rtol=1e-12)
    g = jax.grad(
        lambda l: ssm.objective(l, dt, n, nonlinear=nonlinear)
    )(local)
    gg = ssm.gather(g)
    for name in ("ssh", "layer_thickness", "normal_velocity"):
        np.testing.assert_allclose(
            np.asarray(getattr(gg, name)), np.asarray(getattr(gref, name)),
            rtol=0, atol=1e-11,
        )


@pytest.mark.parametrize("n_devices,nonlinear", [(2, False), (4, False),
                                                 (2, True)])
def test_sharded_slab_fb_matches_global(setup, n_devices, nonlinear):
    """Slab `run` with the forward-backward stepper: linear fb exchanges a
    2-row halo payload per field (reach-2 window), nonlinear fb adds the
    fresh-thickness exchange round — both must match the global roll
    rollout at f64 roundoff."""
    sm, st = setup
    from mpas_ocean.structured.model import StructState

    if nonlinear:
        h = st.layer_thickness + 90.0
        st = StructState(
            ssh=h.sum(-1) - sm.struct_mesh.resting_thickness_sum,
            layer_thickness=h, normal_velocity=st.normal_velocity,
        )
    n, dt = 6, 5.0
    ref = structured_run_loop(st, sm.struct_mesh, dt, n,
                              nonlinear=nonlinear, fb=True)
    ssm = ShardedStructuredModel(
        sm.struct_mesh, devices=jax.devices()[:n_devices]
    )
    out = ssm.gather(
        ssm.run(ssm.scatter(st), dt, n, nonlinear=nonlinear, fb=True)
    )
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), np.asarray(ref.normal_velocity),
        rtol=0, atol=1e-13,
    )


def test_sharded_slab_fb_objective_grad(setup):
    """Differentiable slab fb: jax.grad through objective(fb=True) equals
    the global fb rollout's gradient (ppermute transposes to ppermute
    through the 2-row halo rebuild)."""
    sm, st = setup
    n, dt = 6, 5.0

    def gobj(s):
        out = structured_run_loop(s, sm.struct_mesh, dt, n, fb=True)
        return jnp.sum(out.ssh ** 2)

    gref = jax.grad(gobj)(st)
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:2])
    local = ssm.scatter(st)
    o = ssm.objective(local, dt, n, fb=True)
    np.testing.assert_allclose(float(o), float(gobj(st)), rtol=1e-12)
    gg = ssm.gather(jax.grad(
        lambda l: ssm.objective(l, dt, n, fb=True)
    )(local))
    for name in ("ssh", "layer_thickness", "normal_velocity"):
        np.testing.assert_allclose(
            np.asarray(getattr(gg, name)), np.asarray(getattr(gref, name)),
            rtol=0, atol=1e-11,
        )


@pytest.mark.parametrize("kw", [{}, {"nonlinear": True}, {"fb": True}])
def test_sharded_objective_pallas_grad_matches_global(setup, kw):
    """Differentiable communication-avoiding superstep (checkpointed over
    supersteps, ppermute transposed to ppermute) — jax.grad must match the
    global rollout's gradient at f64 roundoff for linear, nonlinear and
    forward-backward dynamics."""
    sm, st = setup
    from mpas_ocean.structured.model import StructState

    if kw.get("nonlinear"):
        h = st.layer_thickness + 90.0
        st = StructState(
            ssh=h.sum(-1) - sm.struct_mesh.resting_thickness_sum,
            layer_thickness=h, normal_velocity=st.normal_velocity,
        )
    n, dt = 6, 5.0

    def gobj(s):
        out = structured_run_loop(s, sm.struct_mesh, dt, n, **kw)
        return jnp.sum(out.ssh ** 2)

    gref = jax.grad(gobj)(st)
    oref = gobj(st)
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:2])
    local = ssm.scatter(st)
    o = ssm.objective_superstep(local, dt, n, q=2, **kw)
    np.testing.assert_allclose(float(o), float(oref), rtol=1e-12)
    g = jax.grad(
        lambda l: ssm.objective_superstep(l, dt, n, q=2, **kw)
    )(local)
    gg = ssm.gather(g)
    for name in ("ssh", "layer_thickness", "normal_velocity"):
        np.testing.assert_allclose(
            np.asarray(getattr(gg, name)), np.asarray(getattr(gref, name)),
            rtol=0, atol=1e-11,
        )


def test_sharded_objective_forcing_gradient():
    """Wind-stress / drag sensitivity through the MULTI-CHIP objective: a
    pre-scattered forcing slab dict is a differentiated input; the
    gathered cotangent (gather_forcing_grad) matches the global rollout's
    Forcing cotangent at f64 roundoff — wind plane, BOTH level masks, and
    the three scalar coefficients (summed across devices)."""
    from mpas_ocean.mesh.cull import cull_cells
    from mpas_ocean.models.forcing import make_forcing
    from mpas_ocean.models.shallow_water import update_ssh

    nx, Kl = 16, 2
    dc = 1000.0
    parent = planar_hex_mesh(nx, nx, dc, f0=1e-4)
    y = np.asarray(parent.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = cull_cells(parent, keep)
    vert = make_vertical_mesh(
        chan, n_vert_levels=Kl,
        resting_thickness=np.full((chan.n_cells, Kl), 50.0),
    )
    mesh = Mesh(horz=chan, vert=vert).to_device()
    sm = StructuredModel(mesh, nx, nx, parent_horz=parent, keep_cells=keep)
    forcing = make_forcing(
        mesh, wind_stress_zonal=0.1, bottom_drag_linear=1e-4,
        bottom_drag_quadratic=2e-3, rayleigh=1e-5,
    )
    sf = sm.to_struct_forcing(forcing)
    rng = np.random.default_rng(3)
    h = np.full((chan.n_cells, Kl), 50.0) + 0.1 * rng.normal(
        size=(chan.n_cells, Kl)
    )
    u = 0.01 * rng.normal(size=(chan.n_edges, Kl))
    u *= np.asarray(chan.edges.edge_mask)[:, None]
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h), mesh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    st = sm.to_struct(prog)
    smesh = sm.struct_mesh
    n, dt = 6, 5.0

    def gobj(f):
        out = structured_run_loop(st, smesh, dt, n, forcing=f)
        return jnp.sum(out.ssh ** 2)

    gref = jax.grad(gobj)(sf)
    oref = gobj(sf)
    ssm = ShardedStructuredModel(smesh, devices=jax.devices()[:2])
    local = ssm.scatter(st)
    fl = ssm.scatter_forcing(sf)
    o = ssm.objective(local, dt, n, forcing=fl)
    np.testing.assert_allclose(float(o), float(oref), rtol=1e-12)
    dfl = jax.grad(lambda f: ssm.objective(local, dt, n, forcing=f))(fl)
    df = ssm.gather_forcing_grad(dfl, sf)
    for nm in ("wind_edge", "top_mask", "bottom_mask"):
        np.testing.assert_allclose(
            np.asarray(getattr(df, nm)), np.asarray(getattr(gref, nm)),
            rtol=0, atol=1e-13,
        )
    for nm in ("drag_linear", "drag_quadratic", "rayleigh"):
        np.testing.assert_allclose(
            float(getattr(df, nm)), float(getattr(gref, nm)), rtol=1e-10
        )


@pytest.mark.parametrize(
    "config", ["tracers", "strat", "forced_nonlinear", "masked_nonlinear_fb",
               "forced_fb"],
)
def test_superstep_subsystems(config):
    """The superstep covers every subsystem the slab `run` covers, one
    configuration at a time (tracers alone, stratification alone, forcing
    with nonlinear dynamics, wall-masked nonlinear forward-backward at
    reach 3, forced forward-backward) — each equal to the global rollout
    at f64 roundoff, and its objective's gradient equal to the global
    gradient."""
    from mpas_ocean.mesh.cull import cull_cells
    from mpas_ocean.models.forcing import make_forcing
    from mpas_ocean.models.shallow_water import update_ssh
    from mpas_ocean.models.stratification import make_stratification
    from mpas_ocean.models.tracers import make_tracers

    dc = 1000.0
    parent = planar_hex_mesh(NX, NY, dc, f0=1e-4)
    keep, horz = None, parent
    if "masked" in config or "forced" in config:
        y = np.asarray(parent.cells.y)
        keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
        horz = cull_cells(parent, keep)
    depth = 100.0
    vert = make_vertical_mesh(
        horz, n_vert_levels=K,
        resting_thickness=np.full((horz.n_cells, K), depth),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    sm = (StructuredModel(mesh, NX, NY) if keep is None else
          StructuredModel(mesh, NX, NY, parent_horz=parent, keep_cells=keep))
    rng = np.random.default_rng(12)
    h = depth + 0.05 * rng.normal(size=(horz.n_cells, K))
    u = 0.01 * rng.normal(size=(horz.n_edges, K))
    u *= np.asarray(horz.edges.edge_mask)[:, None]
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h), mesh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    kw = {"nonlinear": "nonlinear" in config, "fb": config.endswith("_fb")}
    if config == "tracers":
        x = np.asarray(horz.cells.x)
        prog = prog.replace(tracers=make_tracers(
            mesh, [10.0 + np.sin(2 * np.pi * x / (x.max() + dc)),
                   np.full(horz.n_cells, 35.0)]))
        kw["tracer_kappa"] = 5.0
    if config == "strat":
        kw["strat"] = make_stratification([1024.0, 1025.5, 1026.0])
    if "forced" in config:
        kw["forcing"] = sm.to_struct_forcing(make_forcing(
            mesh, wind_stress_zonal=0.1, bottom_drag_linear=1e-4,
            bottom_drag_quadratic=2e-3, rayleigh=1e-5,
        ))
    st = sm.to_struct(prog)
    n, dt = 4, 5.0
    ref = structured_run_loop(st, sm.struct_mesh, dt, n, **kw)
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:2])
    out = ssm.gather(ssm.run_superstep(ssm.scatter(st), dt, n, q=1, **kw))
    for name in ("ssh", "layer_thickness", "normal_velocity", "tracers"):
        a, b = getattr(out, name), getattr(ref, name)
        if b is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=1e-11)

    def gobj(s):
        return jnp.sum(structured_run_loop(s, sm.struct_mesh, dt, n,
                                           **kw).ssh ** 2)

    gref = jax.grad(gobj)(st)
    local = ssm.scatter(st)
    gg = ssm.gather(jax.grad(
        lambda l: ssm.objective_superstep(l, dt, n, q=1, **kw)
    )(local))
    for name in ("ssh", "layer_thickness", "normal_velocity"):
        b = np.asarray(getattr(gref, name))
        np.testing.assert_allclose(
            np.asarray(getattr(gg, name)), b, rtol=0,
            atol=1e-10 * max(1.0, np.abs(b).max()),
        )
