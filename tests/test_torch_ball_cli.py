"""The port's moving-ball driver (cli.ball.main) against the JAX driver
(svgpvae_tpu.cli.ball.run_experiment).

  * SVGPVAE_Hensman (--clip_qs --ip_joint --GP_joint --entropy_ce, the
    two-pass `reference` cell of the CPU), SVGPVAE_Titsias (--clip_qs, the
    `fused` cell; and `fused_pallas`, the CUDA cell, B1's twin here),
    GPVAE_Pearce (with --GP_joint) and NP: two steps and one eval on the
    driver's widths (35 videos of 32x32 frames, hidden 500) at --tmax 6
    --m 5, from the same --params, with the JAX driver's videos, noise and
    NP draws injected (`video_fn`, `eps_fn`, `np_split_fn`).  The first
    step's gradients against JAX's at the same point, the parameters
    after the steps and the eval's trajectory MSE against the JAX
    driver's;
  * --save and --resume_dir: a run cut at a checkpoint and resumed equals
    the uninterrupted run bit for bit (every parameter, Adam's state, the
    step, the noise and video generators, the eval MSE), and both run
    dirs hold the pictures the JAX driver writes at those steps
    (pics/<step:06d>.png every --plot_every steps);
  * the picture flags run: --show_pics is ignored, --squares_circles
    adds pics/<step:06d>_circles.png and _squares.png, and --save draws
    at the default cadence's steps (each PNG decoded at its size); the
    bad configurations are refused, and no jax import.

Tolerances as tests/test_torch_mnist_train.py: gradients within
GRAD_RTOL = 2e-4 of each tensor's max |entry|; parameters after the
steps within PARAM_ATOL = 1e-4 (a tenth of one Adam step) on every entry
whose first-step gradient is above twice that tolerance (an entry whose
gradient is within what two fp32 implementations can differ by has an
undetermined direction, and Adam moves it by lr all the same); the eval
MSE rtol MSE_RTOL = 1e-4.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, models as jmodels, nn as jnets
from svgpvae_tpu.cli import ball as jball
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig, init_ball_svgp
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import ball as tball
from svgpvae_tpu_torch.utils.convert import ball_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from run_pictures import pictures  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

GRAD_RTOL = 2e-4
PARAM_ATOL = 1e-4
MSE_RTOL = 1e-4
TMAX, M = 6, 5
BASE = ["--steps", "2", "--eval_every", "2", "--tmax", str(TMAX), "--m",
        str(M), "--seed", "0"]
CASES = {
    "hensman": ["--elbo", "SVGPVAE_Hensman", "--clip_qs", "--ip_joint",
                "--GP_joint", "--entropy_ce"],
    "titsias": ["--elbo", "SVGPVAE_Titsias", "--clip_qs"],
    "titsias-fused_pallas": ["--elbo", "SVGPVAE_Titsias", "--clip_qs",
                             "--gp_block_impl", "fused_pallas"],
    "pearce": ["--elbo", "GPVAE_Pearce", "--GP_joint"],
    "np": ["--elbo", "NP"],
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_init(args):
    """The JAX driver's initial parameters (run_experiment's init)."""
    key, init_key = jax.random.split(jax.random.PRNGKey(args.seed or 0))
    enc = jnets.BallEncoder(full_cholesky=args.full_cholesky)
    dec = jnets.BallDecoder(px=32, py=32)
    params = {"enc": enc.init(init_key, jnp.zeros((35, args.tmax, 32, 32))),
              "dec": dec.init(init_key, jnp.zeros((35, args.tmax, 2)))}
    if "SVGPVAE" in args.elbo:
        params["gp"] = init_ball_svgp(
            args.m, tmin=args.ip_min if args.ip_joint else 1.0,
            tmax=args.ip_max if args.ip_joint else float(args.tmax),
            length_scale_init=args.GP_init if args.GP_joint
            else args.vidlt).replace(config=JConfig(
                titsias="Titsias" in args.elbo, jitter=args.jitter))
    elif args.GP_joint:
        params["gp"] = {"length_scale_x": jnp.asarray(args.GP_init),
                        "length_scale_y": jnp.asarray(args.GP_init)}
    return enc, dec, params, key


class JaxDraws:
    """The JAX driver's draws: videos from the t-th split of the data key
    PRNGKey(seed + 1), training noise from the t-th split of the state
    key, the NP's context draws from fold_in(that subkey, 1); eval noise
    and draws from PRNGKey(99)."""

    def __init__(self, args, state_key):
        self.data_key = jax.random.PRNGKey(1234 if args.seed is None
                                           else args.seed + 1)
        self.state_key = state_key
        self.videos = jdata.make_video_batch_fn(tmax=args.tmax,
                                                lt=args.vidlt)
        self.sub = None
        self.keys = []

    def video_fn(self):
        self.data_key, kb = jax.random.split(self.data_key)
        return torch.from_numpy(np.array(self.videos(kb)))

    def eps_fn(self, kind, shape):
        if kind == "train":
            self.state_key, self.sub = jax.random.split(self.state_key)
            self.keys.append(self.sub)
        else:
            self.sub = jax.random.PRNGKey(99)
        return torch.from_numpy(np.array(jax.random.normal(self.sub, shape)))

    def np_split_fn(self, kind, batch, tmax):
        key_n, key_perm = jax.random.split(jax.random.fold_in(self.sub, 1))
        n_ctx = jnp.clip(jnp.round(0.5 * tmax + np.sqrt(0.25 * tmax)
                                   * jax.random.normal(key_n, ())),
                         2, tmax - 2).astype(jnp.int32)
        perm = jax.vmap(lambda k: jax.random.permutation(k, tmax))(
            jax.random.split(key_perm, batch))
        return torch.tensor(int(n_ctx)), torch.from_numpy(
            np.array(perm, np.int64))


def _jax_first_grads(args, enc, dec, params, vids, key):
    """The JAX driver's loss gradient at its first step, in the port's
    names."""
    impl = jmodels.resolve_gp_block_impl(
        "auto" if args.gp_block_impl == "auto" else args.gp_block_impl,
        workload="ball", titsias=args.elbo == "SVGPVAE_Titsias")
    model_lt = 0.001 if args.elbo == "VAE" else args.modellt

    def loss(p):
        if "SVGPVAE" in args.elbo:
            out = jmodels.ball_svgpvae_elbo(
                enc, p["enc"], dec, p["dec"], p["gp"], vids, args.beta0,
                key, clip_qs=args.clip_qs, gp_block_impl=impl,
                entropy_ce=args.entropy_ce)
        else:
            ls = ((p["gp"]["length_scale_x"], p["gp"]["length_scale_y"])
                  if "gp" in p else model_lt)
            out = jmodels.pearce_elbo(
                enc, p["enc"], dec, p["dec"], vids, args.beta0, key, ls,
                elbo_type=args.elbo, context_length_scale=model_lt)
        return -jnp.mean(out.elbo)

    grads = jax.jit(jax.grad(loss))(params)
    return {f"{part}/{k}": _np(v) for part, d in
            ball_params_from_jax(flatten_params(grads)).items()
            for k, v in d.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_main_matches_jax_driver(tmp_path, case):
    argv = CASES[case] + BASE + ["--base_dir", str(tmp_path)]
    jargs = jball.build_parser().parse_args(argv)
    enc, dec, params, state_key = _jax_init(jargs)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))
    draws = JaxDraws(jargs, state_key)
    got = tball.main(argv + ["--device", "cpu", "--params", npz],
                     video_fn=draws.video_fn, eps_fn=draws.eps_fn,
                     np_split_fn=draws.np_split_fn, capture_step=0)
    with contextlib.redirect_stdout(io.StringIO()):
        want = jball.run_experiment(jball.build_parser().parse_args(argv))

    cap = got["captured"]
    g_jax = _jax_first_grads(jargs, enc, dec, params,
                             jnp.asarray(_np(cap["vids"])), draws.keys[0])
    trainable = set(cap["grads"])
    assert trainable <= set(g_jax)
    frozen = {"hensman": set(), "titsias": {"gp/inducing_points",
                                            "gp/length_scale"}}
    assert set(g_jax) - trainable == frozen.get(case.split("-")[0], set())
    held = {}
    for k, g in cap["grads"].items():
        scale = np.abs(g_jax[k]).max()
        err = np.abs(_np(g) - g_jax[k]).max()
        assert err <= GRAD_RTOL * scale, (k, err, scale)
        held[k] = np.abs(g_jax[k]) >= 2 * GRAD_RTOL * scale

    want_params = {f"{part}/{k}": _np(v) for part, d in ball_params_from_jax(
        flatten_params(want["state"].params)).items() for k, v in d.items()}
    got_params = ttrain.named_tensors(got["state"].params)
    assert set(got_params) == set(want_params)
    bad = []
    for k, w in want_params.items():
        err = np.abs(_np(got_params[k]) - w)
        err = err[held[k]] if k in held else err  # frozen: held whole
        if err.size and not err.max() <= PARAM_ATOL:
            bad.append((k, float(err.max())))
    assert not bad, bad
    assert got["state"].step == int(want["state"].step) == 2
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=MSE_RTOL)
    # CPU tensors: no kernel launched
    assert not any(got["launches"].values())


SAVE = ["--elbo", "SVGPVAE_Hensman", "--clip_qs", "--ip_joint", "--tmax",
        "5", "--m", "4", "--eval_every", "2", "--ckpt_every", "2",
        "--plot_every", "2", "--device", "cpu", "--seed", "1"]


def _pictures(run_dir) -> list:
    """The .png names under run_dir/pics, each decoded at the JAX
    figure's size (plot_latents 800 x 600, the probes 800 x 400)."""
    got = pictures(run_dir)
    for name, (h, w, _) in got.items():
        assert (h, w) == ((400, 800) if "_" in name else (600, 800)), name
    return list(got)


@pytest.mark.parametrize("elbo", ["SVGPVAE_Hensman", "NP"])
def test_resume_equals_uninterrupted_run(tmp_path, elbo):
    argv = [{"SVGPVAE_Hensman": elbo}.get(a, a) for a in SAVE]
    argv += ["--base_dir", str(tmp_path)]
    whole = tball.main(argv + ["--steps", "4", "--save", "--expid",
                               "whole"])
    first = tball.main(argv + ["--steps", "2", "--save", "--expid", "cut"])
    run_dir = first["run_dir"]
    assert os.path.isfile(os.path.join(run_dir, "ckpt", "2.pt"))
    assert os.path.isfile(os.path.join(run_dir, "preds", "preds_2.p"))
    rest = tball.main(argv + ["--steps", "4", "--resume_dir", run_dir])
    assert rest["state"].step == 4 and len(rest["step_seconds"]) == 2
    a, b = whole["state"].state_dict(), rest["state"].state_dict()
    assert a["step"] == b["step"] and a["trainable"] == b["trainable"]
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], b["optimizer"]["state"][i][k]), (i, k)
    for k in ("noise", "video_fn"):
        assert torch.equal(whole[k].generator.get_state(),
                           rest[k].generator.get_state()), k
    assert whole["mse"] == rest["mse"]
    # the JAX driver's pictures, {g_s:06d}.png at every --plot_every step
    # (the resumed run adds its own into the cut run's dir)
    for res in (whole, rest):
        assert _pictures(res["run_dir"]) == ["000002.png", "000004.png"]
    assert [e["mse"] for e in whole["evals"]][-1] == rest["evals"][-1]["mse"]
    # the JAX driver's result files
    for name in ("ELBO_results.csv", "GP_params.csv") if "SVGP" in elbo \
            else ("ELBO_results.csv",):
        with open(os.path.join(run_dir, "res", name)) as f:
            header = f.readline().strip().split(",")
        assert header == (tball.ELBO_COLUMNS if name.startswith("ELBO")
                          else tball.GP_COLUMNS)


# the flags refused before the pictures were ported (their
# --data_parallel cases: tests/test_torch_parallel_drivers.py)
@pytest.mark.parametrize("flags,names", [
    (["--show_pics"], None),  # accepted and ignored, as by the JAX driver
    (["--squares_circles", "--save", "--plot_every", "20"],
     ["000020.png", "000020_circles.png", "000020_squares.png"]),
    (["--save", "--plot_every", "10"], ["000010.png", "000020.png"])])
def test_picture_flags_run_and_draw(tmp_path, flags, names):
    res = tball.main(["--elbo", "VAE", "--steps", "20", "--device", "cpu",
                      "--base_dir", str(tmp_path)] + flags)
    assert res["state"].step == 20
    if names is None:
        assert res["run_dir"] is None and res["pictures"] == []
        return
    assert _pictures(res["run_dir"]) == names
    assert [p["step"] for p in res["pictures"]] == sorted(
        {int(p[:6]) for p in names})
    if "--squares_circles" in flags:
        for aligned in res["pictures"][0]["probes"].values():
            assert aligned.shape == (30, 2) and np.isfinite(aligned).all()


def test_bad_configurations_are_refused(tmp_path):
    base = ["--steps", "1", "--device", "cpu", "--base_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="length scales must match"):
        tball.main(["--elbo", "GPVAE_Pearce", "--modellt", "3.0"] + base)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tball.main(["--elbo", "VAE", "--steps", "1", "--device", "cuda",
                        "--base_dir", str(tmp_path)])


def test_vae_setup_check_runs(tmp_path):
    """The README's setup check, at a few steps: finite, one eval, the
    test-batch pickle cached in --base_dir in the JAX driver's format."""
    res = tball.main(["--elbo", "VAE", "--steps", "4", "--eval_every", "2",
                      "--tmax", "5", "--device", "cpu", "--base_dir",
                      str(tmp_path)])
    assert len(res["evals"]) == 2 and np.isfinite(res["mse"])
    assert "gp" not in res["state"].params
    cached = tmp_path / "Test_Batches_2.0_5.pkl"
    assert cached.is_file()
    want = jdata.make_test_batches(10, tmax=5, lt=2.0, batch=35)
    import pickle
    with open(cached, "rb") as f:
        got = pickle.load(f)
    assert all(np.array_equal(g[i], w[i]) for g, w in zip(got, want)
               for i in (0, 1))


def test_ball_entry_point_imports_no_jax():
    """Importing the ball driver adds no jax/flax/optax/sklearn module nor
    the JAX package (compared before/after, so a preloading hook cannot
    mask an import)."""
    code = (
        "import sys\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn',\n"
        "          'svgpvae_tpu')\n"
        "def mods(): return {m for m in sys.modules "
        "if m.split('.')[0] in banned}\n"
        "before = mods()\n"
        "import svgpvae_tpu_torch.cli.ball, svgpvae_tpu_torch.gp.exact\n"
        "import svgpvae_tpu_torch.models.ball, svgpvae_tpu_torch.data.ball\n"
        "import svgpvae_tpu_torch.utils.profiling\n"
        "added = sorted(mods() - before)\n"
        "assert not added, added\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
