"""The port's pictures (utils.png, utils.plots, utils.misc, the ball's
probes, the MNIST kernel pictures' matrices) against the JAX package,
which draws with matplotlib.

  * _video_heatmap, make_circles and make_squares equal JAX's exactly;
  * the colormap tables match matplotlib's 256-entry tables within 1/255,
    and imshow's mapping of values to them exactly;
  * each figure's texts ("Title", "Panel k") equal the strings of the
    figure JAX's function returns (suptitle, then each subplot's title or
    x label, row by row), the grid's chosen indices and the kernels'
    determinants included;
  * the PNG round trip and each picture's size (JAX's figsize x dpi);
  * each image panel holds its image under the colormap at the centres
    of its source pixels, located by the window extents of JAX's
    figure's axes after a draw (so the layout is matplotlib's), and the
    probe's dots and line midpoints lie where JAX's data transform puts
    them;
  * the ball probe's aligned latents (cli.ball.probe_latents) and the
    MNIST kernel triple (cli.mnist.kernel_matrices) at float64 against
    the JAX driver's code on converted weights;
  * a ball run with --squares_circles and an MNIST run, in a process where
    matplotlib and PIL cannot be imported, write every picture.

Tolerances: float64 within 1e-9 (the probe: three layers summed in other
orders) and 1e-12 (the kernels: a few flops a entry) of each output's
max |entry|; colours within 1/255 of matplotlib's (its tables are float,
the PNG bytes).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from svgpvae_tpu import data as jdata, kernels as jkernels, models as jmodels
from svgpvae_tpu.utils import plots as jplots
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch.cli import ball as tball, mnist as tmnist
from svgpvae_tpu_torch.utils import misc as tmisc, plots as tplots
from svgpvae_tpu_torch.utils.png import read_png, write_png

from test_torch_ball import (RTOL64, _ball_gp, _close, _port_nets, _t, _x64,
                             flatten_params)
from test_torch_sprites_train import quick_jit
from torch_threads import _torch_threads  # noqa: E402,F401

matplotlib.use("Agg")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _videos(rng, n=4, t=6, px=32):
    return (rng.rand(n, t, px, px) > 0.93).astype(np.float64)


def _latents_inputs(rng):
    tv = _videos(rng)
    tp = 1.5 * rng.randn(4, 6, 2)
    a = 0.3 * rng.randn(4, 6, 2, 2)
    rv = np.einsum("btij,btkj->btik", a, a)  # symmetric PSD
    return (tv, tp, _videos(rng), tp + 0.2 * rng.randn(4, 6, 2), rv)


def _figure_cases(rng):
    """{name: (port function, JAX function, args, kwargs)}."""
    imgs = rng.rand(11, 28, 28, 1)
    rgb = rng.rand(9, 12, 12, 3) * 1.2 - 0.1
    traj = np.vstack([rng.randn(25, 2), np.zeros((5, 2))])
    mats = [np.eye(6) + 0.3 * rng.randn(6, 6) for _ in range(3)]
    return {
        "latents": ("plot_latents", _latents_inputs(rng), {}),
        "grid": ("plot_image_grid", (imgs, 0.5 * imgs,
                                     "epoch 3. recon MSE test 0.0123"), {}),
        "grid_rgb": ("plot_image_grid", (rgb, rgb[::-1],
                                         "epoch 1. CGEN MSE 0.5000"),
                     dict(nr_images=4, seed=7)),
        "grid_no_seed": ("plot_image_grid", (imgs, imgs, "t"),
                         dict(nr_images=5, seed=None)),
        "circles": ("plot_geometry_probe", (
            tdata.make_circles()[0], tdata.make_circles()[0] + 0.1,
            tdata.make_circles()[1], "circles"), {}),
        "squares": ("plot_geometry_probe", (traj, traj + 0.05,
                                            _videos(rng, 1, 30),
                                            "squares"), {}),
        "kernels": ("plot_kernel_matrices", tuple(mats), dict(batch_idx=3)),
        # the MNIST driver's fp32 kernels: each det in fp32, as JAX's
        "kernels_f32": ("plot_kernel_matrices",
                        tuple(m.astype(np.float32) for m in mats), {}),
    }


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    """Every case drawn by both packages: {name: (port pixels, port
    texts, the JAX figure drawn, args)}."""
    out = tmp_path_factory.mktemp("pics")
    cases = _figure_cases(np.random.RandomState(0))
    result = {}
    for name, (fn, args, kw) in cases.items():
        path = str(out / f"{name}.png")
        pixels = getattr(tplots, fn)(*args, save_path=path, **kw)
        got, text = read_png(path)
        assert np.array_equal(got, pixels)
        fig = getattr(jplots, fn)(*args, **kw)
        fig.canvas.draw()
        result[name] = (got, text, fig, args, kw)
    yield result
    import matplotlib.pyplot as plt
    plt.close("all")


def _jax_texts(fig) -> dict:
    texts = {}
    if fig._suptitle is not None:
        texts["Title"] = fig._suptitle.get_text()
    subplots = [a for a in fig.axes if a.get_subplotspec() is not None
                and a.get_label() != "<colorbar>"]
    for k, ax in enumerate(subplots):
        label = ax.get_title() or ax.get_xlabel()
        if label:
            texts[f"Panel {k}"] = label
    return texts


# --- data and colours --------------------------------------------------------


def test_heatmap_and_probes_equal_jax():
    vid = np.random.RandomState(1).rand(7, 9, 11)
    assert np.array_equal(tplots._video_heatmap(vid),
                          jplots._video_heatmap(vid))
    for t_fn, j_fn in ((tdata.make_circles, jdata.make_circles),
                       (tdata.make_squares, jdata.make_squares)):
        for kw in ({}, dict(px=20, py=24, r=2.5, tmax=27)):
            (tt, tv), (jt, jv) = t_fn(**kw), j_fn(**kw)
            assert np.array_equal(tt, jt) and np.array_equal(tv, jv)
            assert tv.dtype == jv.dtype


@pytest.mark.parametrize("name", ["Greys", "gray", "RdBu_r"])
def test_colormaps_match_matplotlib(name):
    cmap = matplotlib.colormaps[name]
    want = cmap(np.linspace(0, 1, 256))[:, :3]
    assert np.abs(tplots.colormap(name) - want).max() <= 1 / 255
    # imshow's mapping: its own min/max, or a fixed -1..1
    values = np.random.RandomState(2).randn(40, 30)
    norm = matplotlib.colors.Normalize(values.min(), values.max())
    assert np.abs(tplots.apply_colormap(values, name)
                  - cmap(norm(values))[..., :3]).max() <= 1 / 255
    fixed = matplotlib.colors.Normalize(-1.0, 1.0)
    assert np.abs(tplots.apply_colormap(values, name, -1.0, 1.0)
                  - cmap(fixed(values))[..., :3]).max() <= 1 / 255
    assert np.array_equal(tplots.apply_colormap(np.full((3, 3), 0.7), name),
                          cmap(np.zeros((3, 3)))[..., :3])


# --- texts, sizes, PNG -------------------------------------------------------


@pytest.mark.parametrize("name", ["latents", "grid", "grid_rgb",
                                  "grid_no_seed", "circles", "squares",
                                  "kernels", "kernels_f32"])
def test_texts_and_size_match_jax_figure(drawn, name):
    got, text, fig, _, _ = drawn[name]
    assert text == _jax_texts(fig)
    w, h = (fig.get_size_inches() * fig.dpi).round().astype(int)
    assert got.shape == (h, w, 3)
    assert {"latents": (600, 800), "grid": (1000, 1000),
            "grid_rgb": (500, 1000), "grid_no_seed": (1000, 1000),
            "circles": (400, 800), "squares": (400, 800),
            "kernels": (400, 1500), "kernels_f32": (400, 1500)}[name] \
        == got.shape[:2]


def test_png_round_trip_and_video_frames(tmp_path):
    rgb = np.random.RandomState(3).randint(0, 256, (7, 13, 3), np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, rgb, {"Title": "epoch 1. CGEN MSE 0.1234",
                          "Panel 0": "caf\xe9"})
    back, text = read_png(path)
    assert np.array_equal(back, rgb)
    assert text == {"Title": "epoch 1. CGEN MSE 0.1234", "Panel 0": "caf\xe9"}
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    blob[-20] ^= 1  # a byte of the last tEXt chunk
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        read_png(path)
    vids = _videos(np.random.RandomState(4), 2, 3)
    out = tmisc.save_video_frames(vids, str(tmp_path / "frames"), index=1)
    assert sorted(os.listdir(out)) == [f"frame_{t:03d}.png"
                                       for t in range(3)]
    frame, _ = read_png(os.path.join(out, "frame_001.png"))
    assert frame.shape == (180, 180, 3) and len(np.unique(frame)) > 1
    assert tmisc.dict_to_flags({"a": 1, "b": "x"}) == " --a 1 --b x"


# --- pixels where matplotlib puts them ---------------------------------------


def _source_centres(ax, shape, height, origin="upper"):
    """Array (row, col) in the picture of each source pixel's centre of
    the image in ax (matplotlib's window extent after a draw)."""
    x0, y0, w, h = ax.get_window_extent().bounds
    nr, nc = shape
    i, j = np.meshgrid(np.arange(nr), np.arange(nc), indexing="ij")
    if origin == "lower":
        i = nr - 1 - i
    x = x0 + (j + 0.5) * w / nc
    y = y0 + h - (i + 0.5) * h / nr
    return (np.floor(height - y).astype(int), np.floor(x).astype(int))


def _expect_image(got, ax, colors, origin="upper"):
    rows, cols = _source_centres(ax, colors.shape[:2], got.shape[0], origin)
    want = np.rint(colors * 255)
    # interior source pixels (the frame may cover the outermost ones)
    err = np.abs(got[rows, cols].astype(float) - want)[1:-1, 1:-1]
    assert err.max() <= 1, err.max()


def test_image_panels_hold_their_pixels(drawn):
    got, _, fig, (imgs, recon, _), kw = drawn["grid"]
    for k, ax in enumerate(fig.axes):
        idx = int(ax.get_xlabel().split()[-1])
        src = (imgs if k // 4 % 2 == 0 else recon)[idx][..., 0]
        _expect_image(got, ax, tplots.apply_colormap(src, "gray"))
    got, _, fig, (rgb, rgb_rev, _), _ = drawn["grid_rgb"]
    for k, ax in enumerate(fig.axes[:4]):
        idx = int(ax.get_xlabel().split()[-1])
        _expect_image(got, ax, np.clip(rgb[idx], 0, 1))
    got, _, fig, (tv, _, rvids, _, _), _ = drawn["latents"]
    for i in range(4):
        for row, vids in ((0, tv), (2, rvids)):
            _expect_image(got, fig.axes[row * 4 + i], tplots.apply_colormap(
                1 - tplots._video_heatmap(vids[i]), "Greys"), "lower")
    got, _, fig, mats, _ = drawn["kernels"]
    for ax, mat in zip(fig.axes[:3], mats):
        _expect_image(got, ax, tplots.apply_colormap(mat, "RdBu_r", -1, 1))
    got, _, fig, (_, _, vids, _), _ = drawn["squares"]
    _expect_image(got, fig.axes[0], tplots.apply_colormap(
        1 - tplots._video_heatmap(vids[0]), "Greys"), "lower")


@pytest.mark.parametrize("name", ["circles", "squares"])
def test_probe_dots_and_lines_where_matplotlib_puts_them(drawn, name):
    got, _, fig, (true, pred, _, _), _ = drawn[name]
    ax = fig.axes[1]
    assert np.allclose(ax.get_xlim(), tplots._autolim(np.concatenate(
        [true[:19 if name == "circles" else 25],
         pred[:19 if name == "circles" else 25]])[:, 0]))

    def colour_at(pts):
        xy = ax.transData.transform(pts)
        return got[np.floor(got.shape[0] - xy[:, 1]).astype(int),
                   np.floor(xy[:, 0]).astype(int)]

    orange, blue = np.array([255, 165, 0]), np.array([0, 0, 255])
    assert (colour_at(pred[:19]) == orange).all()  # on top (zorder 10)
    if name == "circles":  # the rings' segment midpoints
        mid = (true[1:8] + true[2:9]) / 2
    else:  # the lattice rows' segment midpoints
        mid = (true[0:4] + true[1:5]) / 2
    lit = colour_at(mid)
    assert ((lit == blue).all(1) | (lit == orange).all(1)).all()
    # a pixel far from every point and line stays white
    far = ax.transData.transform([[ax.get_xlim()[0], ax.get_ylim()[1]]])
    corner = got[int(got.shape[0] - far[0, 1]) + 3, int(far[0, 0]) + 3]
    assert (corner == 255).all()


def test_latents_lines_and_ellipses(drawn):
    got, _, fig, (_, tp, _, rp, _), _ = drawn["latents"]
    c0, c1 = np.array([0x1F, 0x77, 0xB4]), np.array([0xFF, 0x7F, 0x0E])
    for i in range(4):
        ax = fig.axes[4 + i]
        xy = ax.transData.transform((tp[i, :-1] + tp[i, 1:]) / 2)
        lit = got[np.floor(got.shape[0] - xy[:, 1]).astype(int),
                  np.floor(xy[:, 0]).astype(int)]
        # the true path's line (C0), unless the recon line (C1, drawn
        # later) or a dot crosses it
        assert ((lit == c0).all(1) | (lit == c1).all(1)).mean() >= 0.6
        # each recon point's ellipse tints its centre towards C1
        xy = ax.transData.transform(rp[i])
        px = got[np.floor(got.shape[0] - xy[:, 1]).astype(int),
                 np.floor(xy[:, 0]).astype(int)].astype(int)
        assert (px[:, 2] < 240).all()


# --- the drivers' helpers at float64 -----------------------------------------


def test_probe_latents_match_jax_f64():
    """cli.ball.probe_latents against the JAX driver's probe code (tile
    the probe video to the batch, eval forward, qnet_mu[0] aligned by
    hstack([qm, 1]) @ W) on the same converted weights, float64."""
    from svgpvae_tpu import nn as jnets
    rng = np.random.RandomState(5)
    T, hidden = 30, (16,)
    W = rng.randn(3, 2)
    with _x64():
        enc = jnets.BallEncoder(hidden=hidden, dtype=jnp.float64)
        dec = jnets.BallDecoder(px=32, py=32, hidden=hidden,
                                dtype=jnp.float64)
        k1, k2 = jax.random.split(jax.random.PRNGKey(2))
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            {"enc": enc.init(k1, jnp.zeros((2, T, 32, 32))),
             "dec": dec.init(k2, jnp.zeros((2, T, 2)))})
        t_enc, t_dec = _port_nets(params, False, T, hidden, 32,
                                  torch.float64)
        j_gp, t_gp, _, _, _ = _ball_gp(rng, T=T)
        key = jax.random.PRNGKey(99)
        eps = np.array(jax.random.normal(key, (35, T, 2), jnp.float64))

        @quick_jit
        def j_qm(p, gp, vids):
            return jmodels.ball_svgpvae_elbo(
                enc, p["enc"], dec, p["dec"], gp, vids, 1.0, key,
                clip_qs=True, gp_block_impl="fused_pallas").qnet_mu

        def forward(_, vids, kind, beta):
            assert kind == "eval" and beta == 1.0
            return tmodels.ball_svgpvae_elbo(
                t_enc, t_dec, t_gp, vids, beta, _t(eps), clip_qs=True,
                gp_block_impl="fused_pallas")

        for kind, maker in (("circles", jdata.make_circles),
                            ("squares", jdata.make_squares)):
            traj, vid, got = tball.probe_latents(
                forward, None, kind, W, T, torch.device("cpu"),
                torch.float64)
            j_traj, j_vid = maker(tmax=T)
            assert np.array_equal(traj, j_traj) and np.array_equal(vid, j_vid)
            qm = np.asarray(j_qm(params, j_gp, jnp.asarray(
                np.tile(j_vid, (35, 1, 1, 1)), jnp.float64))[0])
            want = np.hstack([qm, np.ones((T, 1))]) @ W
            _close(got, want, RTOL64, kind)


@pytest.mark.parametrize("table,normalize", [(True, False), (True, True),
                                             (False, True)])
def test_kernel_matrices_match_jax_f64(table, normalize):
    """cli.mnist.kernel_matrices against the JAX driver's kernel picture
    code on the first rows of an aux array, float64."""
    rng = np.random.RandomState(6)
    n_obj, M = 9, 4
    aux = np.c_[rng.randint(0, n_obj, 20), rng.uniform(0, 2 * np.pi, 20),
                rng.randn(20, M)]
    ov = rng.randn(n_obj, M) if table else None
    amp, ls = 1.3, 0.8
    gp = tgp.MnistSVGP(config=tgp.SVGPConfig(), inducing_points=_t(aux[:3]),
                       length_scale=_t(ls), amplitude=_t(amp),
                       object_vectors=None if ov is None else _t(ov))
    got = tmnist.kernel_matrices(gp, _t(aux), normalize)
    with _x64():
        a = jnp.asarray(aux)
        view = a[:, 1:2]
        obj = (jnp.take(jnp.asarray(ov), a[:, 0].astype(jnp.int32), axis=0)
               if table else a[:, 2:])
        k_view = jkernels.exp_sin_squared_matrix(view, view, amp, ls,
                                                 2.0 * jnp.pi)
        k_obj = jkernels.linear_matrix(obj, obj)
        if normalize:
            k_obj = jkernels.cosine_normalize_matrix(k_obj, obj, obj)
        for g, w, what in zip(got, (k_view, k_obj, k_view * k_obj),
                              ("view", "object", "product")):
            _close(g, np.asarray(w), 1e-12, what)


# --- no matplotlib, no PIL ---------------------------------------------------


def test_drivers_draw_without_matplotlib_or_pil(tmp_path):
    """A saved ball run with --squares_circles and a saved MNIST SVGPVAE
    run in a process where importing matplotlib or PIL fails: every
    picture is written, and neither module was loaded."""
    script = f"""
import os, sys
sys.modules["matplotlib"] = None
sys.modules["PIL"] = None
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads(2)
from svgpvae_tpu_torch import data
from svgpvae_tpu_torch.cli import ball, mnist
from svgpvae_tpu_torch.utils.png import read_png
base = {str(tmp_path)!r}
res = ball.main(["--elbo", "SVGPVAE_Hensman", "--steps", "2",
                 "--eval_every", "2", "--plot_every", "2",
                 "--save", "--squares_circles", "--show_pics", "--device",
                 "cpu", "--base_dir", base])
pics = sorted(os.listdir(os.path.join(res["run_dir"], "pics")))
assert pics == ["000002.png", "000002_circles.png",
                "000002_squares.png"], pics
splits = data.generate_rotated_mnist(
    data.synthetic_digit_base_images("36", per_digit=10, seed=0), None,
    digits="36", seed=0)
res = mnist.main(["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                  "--PCA", "--ov_joint", "--dataset", "36", "--opt_regime",
                  "joint-1", "--eval_every", "1", "--L", "4",
                  "--batch_size", "64", "--device", "cpu", "--save",
                  "--show_pics", "--base_dir", base], splits=splits)
n = res["state"].step
pics = sorted(p for p in os.listdir(os.path.join(res["run_dir"], "pics"))
              if p.endswith(".png"))
assert pics == [f"{{n}}.png", f"{{n}}_cgen.png", f"{{n}}_kernels.png"], pics
for p in pics:
    rgb, text = read_png(os.path.join(res["run_dir"], "pics", p))
    assert rgb.shape in ((1000, 1000, 3), (400, 1500, 3)) and text, p
assert sys.modules["matplotlib"] is None and sys.modules["PIL"] is None
print("drawn without matplotlib")
"""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    done = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "drawn without matplotlib" in done.stdout
