"""The preprocess chain's passes, pass by pass: each plain twin of
ops/preprocess.py (the body csrc/preprocess.cu's kernel copies, and what
the pass runs on CPU tensors) against its JAX pass on the same seeded
inputs, vmapped over the sensors with the pixel models carried across;
the public passes on CPU tensors against their twins, bit for bit and
with no launch; the dispatch rule; the wrappers' refusal of CPU tensors.

Tolerances are tests/test_torch_preprocess.py's for the same maps (which
are tests/test_preprocess.py's): depth and quality 1e-5, silhouette and
the morphed depth 1e-6, LAB and normals 1e-4. The boundary flags and the
silhouette are held exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd_recon_tpu.ops import preprocess as jax_pre

from rgbd_recon_tpu_torch import convert, kernels
from rgbd_recon_tpu_torch.bench import kernel_inputs
from rgbd_recon_tpu_torch.ops import preprocess as port_pre
from rgbd_recon_tpu_torch.ops import stencil13

import preprocess_cases as cases

torch.set_num_threads(2)

# (sensors, depth h, w, colour h, w): a map of odd sides and one smaller
# than a kernel block, so the clamped edges and the partial blocks show
SHAPES = [(2, 37, 53, 41, 67), (3, 7, 5, 9, 11)]
ATOL = {"depth": 1e-5, "quality": 1e-5, "silhouette": 1e-6,
        "raw_depth": 1e-6, "lab": 1e-4, "normal": 1e-4}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _models(inp):
    """(JAX pixel-model tuple, the port's PixelModels) of one case."""
    arrays = {k: inp[k] for k in cases.PIXEL_MODEL_FIELDS}
    jax_pm = tuple(jnp.asarray(arrays[k]) for k in cases.PIXEL_MODEL_FIELDS)
    return jax_pm, convert.pixel_models_from_numpy(arrays, device="cpu")


def _cv_uv(n):
    """A stand-in of the calibration's cv_uv: both packages read only its
    depth planes (the far plane of a degenerate depth)."""
    return np.zeros((n, cases.CV_DEPTH, 2, 2, 2), np.float32)


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
def test_morph_twin_matches_jax(shape):
    n, h, w = shape[:3]
    inp = cases.chain_inputs(1, n, h, w, *shape[3:])
    want = jax.vmap(jax_pre.morph_dilate)(jnp.asarray(inp["depths"]))
    got = port_pre.morph_dilate_plain(_t(inp["depths"]))
    _close(got, want, ATOL["raw_depth"], "morph")
    # the hole stays unfilled, some invalid pixels are filled
    assert float(got[:, h // 5 + 1, w // 7 + 2].abs().max()) == 0.0
    filled = (inp["depths"] == 0.0) & (got.numpy() > 0.0)
    assert filled.any()


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_twin_matches_jax(shape):
    """The LAB pass on the pixel models: degenerate depths at the far
    plane, texcoords past every edge (the pair taps left of the first
    texel)."""
    n, h, w, hc, wc = shape
    inp = cases.chain_inputs(2, n, h, w, hc, wc)
    dn = cases.depth_norm_cases(3, n, h, w)
    jax_pm, pm = _models(inp)
    cv_uv = _cv_uv(n)
    want = jax_pre.lab_colors(jnp.asarray(inp["colors"]), jnp.asarray(dn),
                              jax_pm, jnp.asarray(cv_uv))
    got = port_pre.lab_colors_plain(_t(inp["colors"]), _t(dn), pm,
                                    _t(cv_uv))
    _close(got, want, ATOL["lab"], "lab")
    left = inp["uv_p"][..., 0] < 0.5 / wc   # u * Wc - 0.5 < 0 at z = 0
    assert left.any()


@pytest.mark.parametrize("shape", SHAPES)
def test_lab_twin_pow_branches_match_jax(shape):
    """Colours of 8-bit values (x 255) reach both pow branches of the LAB
    conversion (n > 0.04045, and the cube root past 0.008856), which the
    chain's [0, 1] colours, divided by 255 again, never do: L reaches
    ~90, held at the same atol 1e-4."""
    n, h, w, hc, wc = shape
    inp = cases.chain_inputs(2, n, h, w, hc, wc)
    colors = inp["colors"] * np.float32(255.0)
    dn = cases.depth_norm_cases(3, n, h, w)
    jax_pm, pm = _models(inp)
    cv_uv = _cv_uv(n)
    want = jax_pre.lab_colors(jnp.asarray(colors), jnp.asarray(dn), jax_pm,
                              jnp.asarray(cv_uv))
    got = port_pre.lab_colors_plain(_t(colors), _t(dn), pm, _t(cv_uv))
    _close(got, want, ATOL["lab"], "lab")
    assert float(got[..., 0].max()) > 50.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("filter_on", [True, False])
def test_depth2_twin_matches_jax(shape, filter_on):
    """The bilateral finish and the bbox cull on the pixel models, with
    bilateral13's sums and with the filter off (``bf_sums=None``)."""
    n, h, w = shape[:3]
    inp = cases.chain_inputs(4, n, h, w, *shape[3:])
    jax_pm, pm = _models(inp)
    d_m = port_pre.morph_dilate_plain(_t(inp["depths"]))
    limits = _t(inp["depth_limits"])
    sums = stencil13.bilateral13_plain(d_m, limits) if filter_on else None
    got = port_pre.bilateral_lab_plain(
        d_m, _t(inp["bbox_min"]), _t(inp["bbox_max"]), limits, sums,
        pixel_models=pm)

    def one(d, dl, pm_, s):
        return jax_pre.bilateral_lab(
            d, None, None, None, jnp.asarray(inp["bbox_min"]),
            jnp.asarray(inp["bbox_max"]), dl, filter_on, pixel_model=pm_,
            bf_sums=s, lab_in=jnp.zeros(d.shape + (3,)))[0]

    jsums = None if sums is None else tuple(jnp.asarray(s.numpy())
                                            for s in sums)
    want = jax.vmap(one, in_axes=(0, 0, 0, None if jsums is None else 0))(
        jnp.asarray(d_m.numpy()), jnp.asarray(inp["depth_limits"]), jax_pm,
        jsums)
    _close(got, want, ATOL["depth"], "depth2")
    culled = (got[..., 0] == 0.0).numpy() & (d_m.numpy() > 0.5)
    assert culled.any() and (got[..., 0] > 0.0).any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("refine", [True, False])
def test_boundary_twin_matches_jax(shape, refine):
    n, h, w = shape[:3]
    d2 = cases.depth2_cases(5, n, h, w)
    lab = cases.lab_cases(6, n, h, w)
    want_d, want_s = jax.vmap(jax_pre.boundary, in_axes=(0, 0, None))(
        jnp.asarray(d2), jnp.asarray(lab), refine)
    got_d, got_s = port_pre.boundary_plain(_t(d2), _t(lab), refine)
    _close(got_d[..., 0], want_d[..., 0], ATOL["depth"], "depth")
    np.testing.assert_array_equal(got_d[..., 1].numpy(),
                                  np.asarray(want_d[..., 1]))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    flags = set(np.unique(got_d[..., 1].numpy()).tolist())
    assert (1.0 in flags) == refine and np.float32(0.1) in flags


@pytest.mark.parametrize("shape", kernel_inputs.BOUNDARY_SHAPES)
@pytest.mark.parametrize("refine", [True, False])
def test_boundary_twin_matches_jax_at_odd_tiles(shape, refine):
    """boundary_plain against the JAX pass at shapes that are no multiple
    of the boundary kernel's tile, on maps with invalid pixels along every
    edge (outside, unreliable, invalidated) and a reliable left half
    (bench/kernel_inputs.py boundary_maps): the depth within the file's
    atol, the flags and the silhouette exactly."""
    n, h, w = shape
    d2, lab = (x.numpy() for x in kernel_inputs.boundary_maps(
        torch, shape, 7, torch.device("cpu")))
    want_d, want_s = jax.vmap(jax_pre.boundary, in_axes=(0, 0, None))(
        jnp.asarray(d2), jnp.asarray(lab), refine)
    got_d, got_s = port_pre.boundary_plain(_t(d2), _t(lab), refine)
    _close(got_d[..., 0], want_d[..., 0], ATOL["depth"], "depth")
    np.testing.assert_array_equal(got_d[..., 1].numpy(),
                                  np.asarray(want_d[..., 1]))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    flags = set(np.unique(got_d[..., 1].numpy()).tolist())
    # kept boundary pixels need the refine (and a map past the edges')
    assert np.float32(0.1) in flags and (1.0 in flags) == (
        refine and h * w >= 37 * 70)


@pytest.mark.parametrize("shape", SHAPES)
def test_normals_twin_matches_jax(shape):
    """Normals on the pixel models: invalid neighbours take the centre's
    depth, the edges clamp."""
    n, h, w = shape[:3]
    inp = cases.chain_inputs(7, n, h, w, *shape[3:])
    jax_pm, pm = _models(inp)
    d2 = cases.depth2_cases(8, n, h, w)
    want = jax.vmap(lambda d, p: jax_pre.normals(d, None, pixel_model=p))(
        jnp.asarray(d2), jax_pm)
    got = port_pre.normals_plain(_t(d2), pm)
    _close(got, want, ATOL["normal"], "normal")


@pytest.mark.parametrize("shape", SHAPES)
def test_quality_twin_matches_jax(shape):
    n, h, w = shape[:3]
    inp = cases.chain_inputs(9, n, h, w, *shape[3:])
    jax_pm, pm = _models(inp)
    d2 = cases.depth2_cases(10, n, h, w)
    nrm = cases.normal_cases(11, n, h, w)
    sums = cases.quality_sums(12, n, h, w)
    want = jax.vmap(
        lambda d, nm, c, p, s: jax_pre.quality(d, nm, None, c,
                                               pixel_model=p, q_sums=s))(
        jnp.asarray(d2), jnp.asarray(nrm),
        jnp.asarray(inp["camera_positions"]), jax_pm,
        tuple(jnp.asarray(s) for s in sums))
    got = port_pre.quality_plain(_t(d2), _t(nrm), _t(inp["camera_positions"]),
                                 tuple(_t(s) for s in sums), pm)
    _close(got, want, ATOL["quality"], "quality")
    assert float(got.abs().max()) > 0.0


def _pass_calls(shape, seed=13):
    """{pass: (public call, twin call)} on one case's CPU tensors."""
    n, h, w, hc, wc = shape
    inp = cases.chain_inputs(seed, n, h, w, hc, wc)
    _, pm = _models(inp)
    depths, colors = _t(inp["depths"]), _t(inp["colors"])
    limits = _t(inp["depth_limits"])
    box = (_t(inp["bbox_min"]), _t(inp["bbox_max"]))
    dn = _t(cases.depth_norm_cases(seed, n, h, w))
    cv_uv = _t(_cv_uv(n))
    d_m = port_pre.morph_dilate_plain(depths)
    sums = stencil13.bilateral13_plain(d_m, limits)
    d2 = _t(cases.depth2_cases(seed, n, h, w))
    lab = _t(cases.lab_cases(seed, n, h, w))
    nrm = _t(cases.normal_cases(seed, n, h, w))
    q_sums = tuple(_t(s) for s in cases.quality_sums(seed, n, h, w))
    cams = _t(inp["camera_positions"])
    args = {
        "morph_dilate": (depths,),
        "lab_colors": (colors, dn, pm, cv_uv),
        "bilateral_lab": (d_m, *box, limits, sums, pm),
        "bilateral_lab_off": (d_m, *box, limits, None, pm),
        "boundary": (d2, lab, True),
        "boundary_off": (d2, lab, False),
        "normals": (d2, pm),
        "quality": (d2, nrm, cams, q_sums, pm),
    }
    return {name: (getattr(port_pre, name.removesuffix("_off")),
                   getattr(port_pre, name.removesuffix("_off") + "_plain"),
                   a) for name, a in args.items()}


PASSES = ["morph_dilate", "lab_colors", "bilateral_lab", "bilateral_lab_off",
          "boundary", "boundary_off", "normals", "quality"]


@pytest.mark.parametrize("name", PASSES)
def test_cpu_passes_run_their_twins(name):
    """On CPU tensors each public pass is its twin, bit for bit, and
    launches nothing."""
    public, plain, args = _pass_calls(SHAPES[0])[name]
    kernels.reset_launch_counts()
    got, want = public(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_kernel_passes_rule():
    """The calibration passes launch on a CUDA tensor with the pixel
    models only: never on the CPU, never through the volumes."""
    _, pm = _models(cases.chain_inputs(0, 1, 4, 4, 4, 4))
    cpu = torch.zeros(1, 4, 4)
    meta = torch.empty(1, 4, 4, device="meta")
    assert not port_pre.kernel_passes(cpu, pm)
    assert not port_pre.kernel_passes(cpu, None)
    assert not port_pre.kernel_passes(meta, None)
    assert port_pre.kernel_passes(meta, pm)


def test_preprocess_frames_on_cpu_launches_nothing():
    """The whole chain on CPU tensors equals the chain of twins and
    launches no kernel."""
    n, h, w, hc, wc = SHAPES[0]
    inp = cases.chain_inputs(14, n, h, w, hc, wc)
    _, pm = _models(inp)
    kw = dict(cv_xyz=None, cv_uv=_t(_cv_uv(n)),
              bbox_min=_t(inp["bbox_min"]), bbox_max=_t(inp["bbox_max"]),
              depth_limits=_t(inp["depth_limits"]),
              camera_positions=_t(inp["camera_positions"]), pixel_models=pm)
    kernels.reset_launch_counts()
    got = port_pre.preprocess_frames(_t(inp["depths"]), _t(inp["colors"]),
                                     **kw)
    assert all(v == 0 for v in kernels.launch_counts().values())
    d_m = port_pre.morph_dilate_plain(_t(inp["depths"]))
    limits = kw["depth_limits"]
    near, far = limits[:, 0].view(n, 1, 1), limits[:, 1].view(n, 1, 1)
    lab = port_pre.lab_colors_plain(_t(inp["colors"]),
                                    (d_m - near) / (far - near), pm,
                                    kw["cv_uv"])
    d2 = port_pre.bilateral_lab_plain(
        d_m, kw["bbox_min"], kw["bbox_max"], limits,
        stencil13.bilateral13_plain(d_m, limits), pm)
    d2, sil = port_pre.boundary_plain(d2, lab, True)
    nrm = port_pre.normals_plain(d2, pm)
    qual = port_pre.quality_plain(
        d2, nrm, kw["camera_positions"],
        stencil13.quality13_plain(d2[..., 0].contiguous()), pm)
    for field, want in (("raw_depth", d_m), ("lab", lab), ("depth", d2),
                        ("silhouette", sil), ("normal", nrm),
                        ("quality", qual)):
        assert torch.equal(getattr(got, field), want), field


WRAPPERS = ["morph_cuda", "lab_cuda", "depth2_cuda", "boundary_cuda",
            "normals_cuda", "quality_cuda"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_reject_cpu_tensors(name):
    """The wrappers of csrc/preprocess.cu take CUDA tensors only: on CPU
    tensors they raise before building or launching anything."""
    from rgbd_recon_tpu_torch.kernels import preprocess as kp

    calls = _pass_calls(SHAPES[1])
    args = {
        "morph_cuda": calls["morph_dilate"][2],
        "lab_cuda": calls["lab_colors"][2][:3] + (0.97,),
        "depth2_cuda": calls["bilateral_lab"][2],
        "boundary_cuda": calls["boundary"][2],
        "normals_cuda": calls["normals"][2],
        "quality_cuda": calls["quality"][2],
    }[name]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kp, name)(*args)
    assert all(v == 0 for v in kernels.launch_counts().values())
