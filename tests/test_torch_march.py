"""The port's march modules against the JAX package's, on the CPU.

Module by module: trilinear sampling and its forward-difference
gradient (f32, bf16, u8 grids), rays and the blended optical flow, the
macrocell queries, the shadow march, the march itself in every shading
(with macrocells, adaptive steps, a t cap and given jitter), the
early-exit loop, and the per-point shadow lattice. Inputs are made
with numpy from a seed and fed to both packages. Tolerances: rgba and
normals 5e-5, depth 2e-4, flow 1e-4; gradients 2e-3 of the largest
element of JAX's.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu.core import sampling as jsamp
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.render import accel as jaccel
from ovr_tpu.render import camera as jcamera
from ovr_tpu.render import integrator as jig
from ovr_tpu.render import lightgrid as jlg
from ovr_tpu_torch.core import sampling
from ovr_tpu_torch.core.scene import Camera
from ovr_tpu_torch.render import accel, camera, integrator, lightgrid
from tests.test_torch_render import _field


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0.0)


def grids(kind="smooth", n=20):
    """(JAX grid, port grid) per storage type, the same values."""
    g = _field(n, kind)
    u8 = np.clip(np.round(g * 255), 0, 255).astype(np.uint8)
    u16 = np.clip(np.round(g * 65535), 0, 65535).astype(np.uint16)
    return {"f32": (jnp.asarray(g), t(g)),
            "bf16": (jnp.asarray(g, jnp.bfloat16),
                     t(g).to(torch.bfloat16)),
            "u8": (jnp.asarray(u8), t(u8)),
            "u16": (jnp.asarray(u16), t(u16))}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16", "u8", "u16"])
def test_sample_volume_and_gradient_match_jax(dtype):
    jg, tg = grids(n=13)[dtype]
    rng = np.random.default_rng(1)
    # inside, on the half-texel border, and outside the unit cube
    p = rng.uniform(-0.2, 1.2, (500, 3)).astype(np.float32)
    p[:20] = np.round(p[:20] * 26) / 26
    s_j = jsamp.sample_volume(jg, jnp.asarray(p))
    s_t = sampling.sample_volume(tg, t(p))
    assert s_t.dtype == torch.float32
    close(s_t, s_j, 1e-6)
    g_j = jsamp.volume_gradient(jg, jnp.asarray(p), s_j)
    g_t = sampling.volume_gradient(tg, t(p), s_t)
    close(g_t, g_j, 2e-4 * float(jnp.abs(g_j).max()))
    # gradient_of with a boundary inside the cube (a brick's halo)
    rdim = np.array([0.05, 0.07, 0.03], np.float32)
    hi = np.array([0.9, 1.0, 0.8], np.float32)
    gj = jsamp.gradient_of(lambda q: jsamp.sample_volume(jg, q),
                           jnp.asarray(p), s_j, jnp.asarray(rdim),
                           hi=jnp.asarray(hi))
    gt = sampling.gradient_of(lambda q: sampling.sample_volume(tg, q), t(p),
                              s_t, t(rdim), hi=t(hi))
    close(gt, gj, 1e-4 * float(jnp.abs(gj).max()))


def test_sample_volume_vjp_matches_jax():
    """Cotangents of the grid and of the points, clamped points and
    half-texel borders included."""
    jg, tg = grids(n=9)["f32"]
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    p[:30, 0] = 0.5 / 9  # on the first texel centre
    w = rng.normal(size=300).astype(np.float32)

    def jl(g, q):
        return jnp.sum(jsamp.sample_volume(g, q) * w)

    want = jax.grad(jl, argnums=(0, 1))(jg, jnp.asarray(p))
    g = tg.clone().requires_grad_(True)
    q = t(p).requires_grad_(True)
    (sampling.sample_volume(g, q) * t(w)).sum().backward()
    close(g.grad, want[0], 1e-5)
    close(q.grad, want[1], 1e-4)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

CAMS = {
    "persp": dict(from_=(0.6, 0.4, -1.7), at=(0.5, 0.5, 0.5), fovy=45.0),
    "ortho": dict(from_=(0.5, 0.5, -2.0), at=(0.45, 0.55, 0.5), height=1.3,
                  kind="orthographic"),
}


def cams(name, **over):
    kw = dict(CAMS[name], **over)
    return JCamera.create(**kw), Camera.create(**kw, device="cpu")


@pytest.mark.parametrize("name", ["persp", "ortho"])
def test_generate_rays_and_flow_match_jax(name):
    jc, tc = cams(name)
    last = dict(from_=(0.7, 0.45, -1.6)) if name == "persp" else dict(
        from_=(0.55, 0.5, -2.0))
    jl, tl = cams(name, **last)
    rng = np.random.default_rng(3)
    sc = rng.uniform(0, 1, (200, 2)).astype(np.float32)
    jo, jd = jcamera.generate_rays(jc, jnp.asarray(sc), 32, 24)
    to, td = camera.generate_rays(tc, t(sc), 32, 24)
    close(to, jo, 1e-6)
    close(td, jd, 1e-6)
    n = np.array([[0.3, -0.2, 0.9]], np.float32)
    close(camera.world_to_camera_normal(tc, 32, 24, t(n)),
          jcamera.world_to_camera_normal(jc, 32, 24, jnp.asarray(n)), 1e-6)
    alpha = rng.uniform(0, 1, 200).astype(np.float32)
    alpha[:10] = 0.0
    depth = (alpha * rng.uniform(0.5, 3.0, 200)).astype(np.float32)
    fj = jcamera.blended_flow(jc, jl, 32, 24, jo, jd, jnp.asarray(depth),
                              jnp.asarray(alpha))
    ft = camera.blended_flow(tc, tl, 32, 24, to, td, t(depth), t(alpha))
    assert float(ft.abs().max()) > 1e-3
    close(ft, fj, 1e-4)


# ---------------------------------------------------------------------------
# macrocells
# ---------------------------------------------------------------------------

def macrocell_pair(n=40, kind="sparse"):
    g = _field(n, kind)
    alpha = np.concatenate([np.zeros(10), np.linspace(0, 0.9, 22)])
    alpha = alpha.astype(np.float32)
    vr = np.array([0.0, 1.0], np.float32)
    jm = jaccel.build_macrocells(jnp.asarray(g), jnp.asarray(alpha),
                                 jnp.asarray(vr))
    tm = accel.build_macrocells(t(g), t(alpha), t(vr))
    return jm, tm, g, alpha


def test_macrocell_queries_match_jax():
    jm, tm, _, _ = macrocell_pair()
    empty = np.asarray(jm.majorant) <= 1.19e-7
    assert empty.any() and not empty.all()
    rng = np.random.default_rng(4)
    p = rng.uniform(-0.1, 1.1, (400, 3)).astype(np.float32)
    p[:40] = np.round(p[:40] * 40 / 16) * 16 / 40  # on cell faces
    assert np.array_equal(tm.cell_index(t(p)).numpy(),
                          np.asarray(jm.cell_index(jnp.asarray(p))))
    close(tm.majorant_at(t(p)), jm.majorant_at(jnp.asarray(p)), 0.0)
    assert np.array_equal(tm.is_empty(t(p)).numpy(),
                          np.asarray(jm.is_empty(jnp.asarray(p))))
    org = rng.uniform(-1, 2, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d[:50, 0] = 0.0  # parallel to a slab
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tt = rng.uniform(0, 2, 400).astype(np.float32)
    lo = np.array([-0.2, 0.0, 0.1], np.float32)
    hi = np.array([1.3, 1.0, 0.9], np.float32)
    close(tm.cell_exit_t(t(org), t(d), t(tt), t(lo), t(hi)),
          jm.cell_exit_t(jnp.asarray(org), jnp.asarray(d), jnp.asarray(tt),
                         jnp.asarray(lo), jnp.asarray(hi)), 2e-6)


# ---------------------------------------------------------------------------
# the march
# ---------------------------------------------------------------------------

def scene_leaves(g, alpha=None, n_tab=16, base=1.0):
    """(JAX leaves, port leaves) for grid g (numpy or a pair)."""
    color = np.stack([np.linspace(0, 1, n_tab), 0.5 * np.ones(n_tab),
                      np.linspace(1, 0, n_tab)], -1).astype(np.float32)
    if alpha is None:
        alpha = np.linspace(0.0, 1.0, n_tab).astype(np.float32)
    vr = np.array([float(np.min(g)), float(np.max(g))], np.float32)
    b = np.float32(base)
    jl = (jnp.asarray(g), jnp.asarray(color), jnp.asarray(alpha),
          jnp.asarray(vr), jnp.asarray(b))
    tl = (t(g), t(color), t(alpha), t(vr), t(b))
    return jl, tl


def ctx_pair(rng, lattice=False, extra=0, points=0):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    ld = rng.normal(size=3)
    ld /= np.linalg.norm(ld)
    f = dict(light_dir=ld.astype(np.float32), wtc=q.astype(np.float32),
             world_lo=np.zeros(3, np.float32),
             world_hi=np.ones(3, np.float32))
    if lattice:
        f["light_alpha"] = rng.uniform(0, 0.6, (10, 12, 11)).astype(
            np.float32)
    if extra:
        d = rng.normal(size=(extra, 3))
        f["extra_dirs"] = (d / np.linalg.norm(d, axis=-1, keepdims=True)
                           ).astype(np.float32)
        f["extra_dir_intens"] = rng.uniform(0.5, 1.5, extra).astype(
            np.float32)
    if points:
        f["point_pos"] = rng.uniform(-0.5, 1.5, (points, 3)).astype(
            np.float32)
        f["point_intens"] = rng.uniform(0.5, 1.5, points).astype(np.float32)
    return (jig.ShadeContext(**{k: jnp.asarray(v) for k, v in f.items()}),
            integrator.ShadeContext(**{k: t(v) for k, v in f.items()}))


def rays(name="persp", w=20, h=16):
    jc, _ = cams(name)
    sc = jcamera.pixel_screen_coords(w, h).reshape(-1, 2)
    o, d = jcamera.generate_rays(jc, sc, w, h)
    return np.asarray(o), np.asarray(d)


# (name, shading, camera, field, lattice, extra, points, macrocells,
#  adaptive, t_cap, jitter)
MARCH_CASES = [
    ("none", "none", "persp", "smooth", False, 0, 0, False, 1.0, 0, 0),
    ("diffuse-lights", "diffuse", "persp", "smooth", False, 2, 1, False,
     1.0, 0, 0),
    ("shadow-lattice", "shadow", "ortho", "smooth", True, 0, 0, False, 1.0,
     0, 0),
    ("shadow-exact", "shadow", "persp", "smooth", False, 0, 0, False, 1.0,
     0, 0),
    ("ssh-lattice", "ssh", "persp", "smooth", True, 0, 0, False, 1.0, 0, 0),
    ("ssh-exact", "ssh", "ortho", "smooth", False, 0, 0, False, 1.0, 0, 0),
    ("diffuse-skip", "diffuse", "persp", "sparse", False, 0, 0, True, 1.0,
     0, 0),
    ("none-adaptive", "none", "persp", "sparse", False, 0, 0, True, 4.0, 0,
     0),
    ("diffuse-cap-jitter", "diffuse", "persp", "smooth", False, 1, 0, False,
     1.0, 1, 1),
]
SPARSE_ALPHA = np.concatenate([np.zeros(10), np.linspace(0, 0.9, 22)]
                              ).astype(np.float32)


def march_inputs(case, n=20, rate=24.0):
    (_, shading, cam, kind, lattice, extra, points, mc, adaptive, cap,
     jit) = case
    rng = np.random.default_rng(5)
    g = _field(n, kind)
    alpha = SPARSE_ALPHA if kind == "sparse" else None
    jl, tl = scene_leaves(g, alpha, n_tab=32 if alpha is not None else 16)
    jctx, tctx = ctx_pair(rng, lattice, extra, points)
    cfg = dict(max_steps=int(np.ceil(np.sqrt(3) * rate)) + 2,
               shading=shading, shadow_max_steps=7, adaptive_scale=adaptive)
    o, d = rays(cam)
    kw_j, kw_t = {}, {}
    if mc:
        kw_j["occupancy"] = jaccel.build_macrocells(jl[0], jl[2], jl[3])
        kw_t["occupancy"] = accel.build_macrocells(tl[0], tl[2], tl[3])
    if cap:
        c = rng.uniform(1.2, 2.4, o.shape[0]).astype(np.float32)
        kw_j["t_cap"], kw_t["t_cap"] = jnp.asarray(c), t(c)
    if jit:
        j = rng.uniform(0, 1, o.shape[0]).astype(np.float32)
        kw_j["jitter"], kw_t["jitter"] = jnp.asarray(j), t(j)
    step = np.float32(1.0 / rate)
    return ((jnp.asarray(o), jnp.asarray(d), jl, jctx,
             jig.MarchConfig(**cfg), jnp.asarray(step)), kw_j,
            (t(o), t(d), tl, tctx, integrator.MarchConfig(**cfg), t(step)),
            kw_t)


def assert_march_close(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        close(a, b, 2e-4 if k == 2 else 5e-5)
    assert float(got[3].max()) > 0.1  # the volume is in view


@pytest.mark.parametrize("case", MARCH_CASES, ids=[c[0] for c in MARCH_CASES])
def test_march_matches_jax(case, monkeypatch):
    jargs, jkw, targs, tkw = march_inputs(case)
    assert_march_close(integrator.march(*targs, **tkw),
                       jig.march(*jargs, **jkw))
    if case[7]:  # skipping really skips: the rays finish in fewer steps
        monkeypatch.setattr(integrator, "CHECK_EVERY", 1)
        with torch.no_grad():
            n0 = integrator.STEPS
            integrator.march_while(*targs, **tkw)
            n1 = integrator.STEPS
            integrator.march_while(*targs, **dict(tkw, occupancy=None))
            assert n1 - n0 < integrator.STEPS - n1


@pytest.mark.parametrize("case", [MARCH_CASES[i] for i in (1, 3, 5, 7)],
                         ids=[MARCH_CASES[i][0] for i in (1, 3, 5, 7)])
def test_march_while_equals_march(case):
    """The early-exit loop gives the full march's bits, and JAX's."""
    jargs, jkw, targs, tkw = march_inputs(case)
    full = integrator.march(*targs, **tkw)
    n0 = integrator.STEPS
    early = integrator.march_while(*targs, **tkw)
    ran = integrator.STEPS - n0
    assert ran < targs[4].max_steps
    for a, b in zip(early, full):
        assert torch.equal(a, b)
    assert_march_close(early, jig.march_while(*jargs, **jkw))


def test_march_while_raises_under_grad():
    _, _, (o, d, leaves, ctx, cfg, step), _ = march_inputs(MARCH_CASES[0])
    g = leaves[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        integrator.march_while(o, d, (g,) + leaves[1:], ctx, cfg, step)
    with torch.no_grad():
        integrator.march_while(o, d, (g,) + leaves[1:], ctx, cfg, step)


@pytest.mark.parametrize("shading", ["diffuse", "shadow"])
def test_march_vjp_matches_jax(shading):
    """Cotangents of the grid, the TF tables and the rays through a
    march with two extra lights and a point light (exact shadows)."""
    case = ("g", shading, "persp", "smooth", False, 2, 1, False, 1.0, 0, 0)
    jargs, _, targs, _ = march_inputs(case, n=10, rate=12.0)
    jo, jd, jl, jctx, jcfg, jstep = jargs
    to, td, tl, tctx, tcfg, tstep = targs

    def jloss(g, color, alpha, o, d):
        c, gr, dep, a = jig.march(o, d, (g, color, alpha) + jl[3:], jctx,
                                  jcfg, jstep)
        return jnp.sum(c ** 2) + jnp.sum(a) + jnp.sum(gr ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jl[0], jl[1], jl[2], jo,
                                                    jd)
    xs = [x.clone().requires_grad_(True) for x in (tl[0], tl[1], tl[2], to,
                                                    td)]
    c, gr, dep, a = integrator.march(xs[3], xs[4], tuple(xs[:3]) + tl[3:],
                                     tctx, tcfg, tstep)
    ((c ** 2).sum() + a.sum() + (gr ** 2).sum()).backward()
    for x, w in zip(xs, want):
        scale = float(jnp.abs(w).max())
        assert scale > 0
        close(x.grad, w, 2e-3 * scale)


def test_shadow_alpha_matches_jax():
    rng = np.random.default_rng(6)
    jl, tl = scene_leaves(_field(16))
    pos = rng.uniform(-0.2, 1.2, (300, 3)).astype(np.float32)
    ld = np.array([0.3, 0.8, -0.5], np.float32)
    ld /= np.linalg.norm(ld)
    cfg = dict(max_steps=10, shadow_scale=10.0, shadow_max_steps=9)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    want = jig._shadow_alpha(*jl, jnp.asarray(pos), jnp.asarray(ld),
                             jnp.asarray(lo), jnp.asarray(hi),
                             jnp.float32(1 / 32), jig.MarchConfig(**cfg))
    got = integrator._shadow_alpha(*tl, t(pos), t(ld), t(lo), t(hi),
                                   torch.tensor(1 / 32),
                                   integrator.MarchConfig(**cfg))
    assert float(got.max()) > 0.1
    close(got, want, 5e-5)


def test_per_point_light_grid_matches_jax():
    jl, tl = scene_leaves(_field(16))
    ld = np.array([-0.4, 0.7, 0.5], np.float32)
    ld /= np.linalg.norm(ld)
    lo = np.array([0.0, -0.1, 0.2], np.float32)
    hi = np.array([1.0, 1.2, 0.9], np.float32)
    cfg = dict(max_steps=30, shadow_scale=10.0, shadow_max_steps=6)
    want = jlg.build_light_grid(jl, jnp.asarray(ld), jnp.asarray(lo),
                                jnp.asarray(hi), jnp.float32(1 / 24),
                                jig.MarchConfig(**cfg), (9, 10, 11))
    got = lightgrid.build_light_grid(tl, t(ld), t(lo), t(hi),
                                     torch.tensor(1 / 24),
                                     integrator.MarchConfig(**cfg),
                                     (9, 10, 11))
    assert tuple(got.shape) == (9, 10, 11) and float(got.max()) > 0.1
    close(got, want, 5e-5)


@pytest.mark.parametrize("dtype", ["bf16", "u8"])
def test_march_on_stored_types_matches_jax(dtype):
    """bf16 gathers bf16 and interpolates in f32, u8 samples as
    raw/255, in the march as in JAX."""
    jg, tg = grids(n=20)[dtype]
    jargs, jkw, targs, tkw = march_inputs(MARCH_CASES[1])
    jargs = jargs[:2] + ((jg,) + jargs[2][1:],) + jargs[3:]
    targs = targs[:2] + ((tg,) + targs[2][1:],) + targs[3:]
    assert_march_close(integrator.march(*targs, **tkw),
                       jig.march(*jargs, **jkw))
