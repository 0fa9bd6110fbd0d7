"""Carry parameters of the JAX package over to the port.

`params_from_jax` takes the flax/JAX parameter tree of a SPRITES SVGPVAE,
flattened to numpy arrays under "/"-joined paths (the `.npz` that
tools/export_jax_params.py writes):

    vae/params/enc_conv0/kernel, ..., repr/params/conv0/kernel, ...,
    gp/inducing_points, gp/gplvm_action, gp/l_action, ...

and returns {"vae": SpritesVAE state dict, "repr": SpritesReprNet state
dict, "gp": {field: tensor}} for `load_state_dict` and
`gp.svgp.init_sprites_svgp`.

`sprites_train_params_from_jax` takes the flat parameters of a SPRITES
training run (the same layout, plus the repr-net pretraining head under
head/params/Dense_0/...) and returns the port's modules and SpritesSVGP:
{"vae": SpritesVAE, "repr": SpritesReprNet, "gp": SpritesSVGP, "head":
ClassificationHead (when present)}.

`ball_params_from_jax` takes the flat parameters of a moving-ball run
({"enc": flax BallEncoder params, "dec": BallDecoder params, "gp":
BallSVGP, or Pearce's {"length_scale_x", "length_scale_y"} under
--GP_joint}, flattened alike: enc/params/Dense_0/kernel, ...,
gp/inducing_points) and returns {"enc": BallEncoder state dict, "dec":
BallDecoder state dict, "gp": {field: tensor}} (no "gp" when the run has
none).  `params_from_jax` dispatches a ball tree to it.

`mnist_params_from_jax` does the same for a rotated-MNIST SVGPVAE
({"vae": flax MnistVAE params, "gp": MnistSVGP}, flattened alike:
vae/params/encoder/Conv_0/kernel, ..., gp/inducing_points, ...) and
returns {"vae": MnistVAE state dict, "gp": {field: tensor}}; the GPLVM
table gp/object_vectors is optional.  `cvae_params_from_jax`,
`svigp_params_from_jax` and `casale_params_from_jax` do the same for the
MNIST baselines (the CVAE; the deep-SVIGP decoder and SVIGP leaves; the
Casale VAE and CasaleGP leaves).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from svgpvae_tpu_torch.gp.svgp import SpritesSVGP, SVGPConfig
from svgpvae_tpu_torch.nn.nets import (ClassificationHead, SpritesReprNet,
                                       SpritesVAE)

GP_FIELDS = ("inducing_points", "gplvm_action", "l_action", "sigma_action",
             "l_character", "sigma_character")
MNIST_GP_FIELDS = ("inducing_points", "length_scale", "amplitude")


def _t(a) -> torch.Tensor:
    """float64 arrays stay float64 (gradients held at float64 in the
    tests); everything else becomes float32."""
    a = np.asarray(a)
    dtype = np.float64 if a.dtype == np.float64 else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, order="C"))


def _conv(kernel: np.ndarray) -> torch.Tensor:
    """flax HWIO -> torch OIHW."""
    return _t(np.transpose(kernel, (3, 2, 0, 1)))


def _module(flat: Dict[str, np.ndarray], prefix: str):
    """{layer: {"kernel": ..., "bias": ...}} under `prefix` (e.g. vae/params)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        if key.startswith(prefix + "/"):
            layer, leaf = key[len(prefix) + 1:].rsplit("/", 1)
            out.setdefault(layer, {})[leaf] = np.asarray(value)
    return out


def sprites_vae_state(p: Dict[str, Dict[str, np.ndarray]]) -> dict:
    """State dict of nn.nets.SpritesVAE from the flax SpritesVAE params.

    The encoder flattens (8, 8, f) NHWC maps in (h, w, c) order and the
    decoder reshapes its Dense output to (8, 8, f) NHWC; torch flattens
    and reshapes (c, h, w), so the Dense rows/columns are permuted.
    """
    f = p["enc_conv0"]["bias"].shape[0]
    side = int(round((p["enc_out"]["kernel"].shape[0] // f) ** 0.5))
    state = {}
    for i in range(6):
        state[f"enc_convs.{i}.weight"] = _conv(p[f"enc_conv{i}"]["kernel"])
        state[f"enc_convs.{i}.bias"] = _t(p[f"enc_conv{i}"]["bias"])
        state[f"dec_convs.{i}.weight"] = _conv(p[f"dec_conv{i}"]["kernel"])
        state[f"dec_convs.{i}.bias"] = _t(p[f"dec_conv{i}"]["bias"])
    state["dec_out.weight"] = _conv(p["dec_out"]["kernel"])
    state["dec_out.bias"] = _t(p["dec_out"]["bias"])

    w = p["enc_out"]["kernel"]  # (h*w*c, 2L) rows in (h, w, c) order
    w = w.reshape(side, side, f, -1).transpose(2, 0, 1, 3).reshape(w.shape)
    state["enc_out.weight"] = _t(w.T)
    state["enc_out.bias"] = _t(p["enc_out"]["bias"])

    w = p["dec_in"]["kernel"]  # (L, h*w*c) columns in (h, w, c) order
    L = w.shape[0]
    w = w.reshape(L, side, side, f).transpose(0, 3, 1, 2).reshape(w.shape)
    state["dec_in.weight"] = _t(w.T)
    b = p["dec_in"]["bias"].reshape(side, side, f).transpose(2, 0, 1)
    state["dec_in.bias"] = _t(b.reshape(-1))
    return state


def sprites_repr_state(p: Dict[str, Dict[str, np.ndarray]]) -> dict:
    """State dict of nn.nets.SpritesReprNet from the flax params."""
    state = {}
    for i in range(3):
        state[f"convs.{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        state[f"convs.{i}.bias"] = _t(p[f"conv{i}"]["bias"])
    return state


def params_from_jax(flat: Dict[str, np.ndarray]) -> dict:
    """Flat JAX SPRITES SVGPVAE parameters -> the port's (see module doc);
    a moving-ball tree (enc/..., dec/...) goes to ball_params_from_jax, and
    a tree without gp/ leaves (a plain VAE run) gives {"vae"} alone."""
    if any(k.startswith("enc/") for k in flat):
        return ball_params_from_jax(flat)
    if not any(k.startswith("gp/") for k in flat):  # a plain VAE run
        return {"vae": sprites_vae_state(_module(flat, "vae/params"))}
    missing = [f"gp/{k}" for k in GP_FIELDS if f"gp/{k}" not in flat]
    if missing:
        raise KeyError(f"missing GP parameters: {missing}")
    return {
        "vae": sprites_vae_state(_module(flat, "vae/params")),
        "repr": sprites_repr_state(_module(flat, "repr/params")),
        "gp": {k: _t(flat[f"gp/{k}"]) for k in GP_FIELDS},
    }


def sprites_train_params_from_jax(flat: Dict[str, np.ndarray],
                                  config: SVGPConfig, L_action: int,
                                  use_se_kernel: bool = False) -> dict:
    """Flat JAX SPRITES training parameters -> the port's modules and GP
    (see the module doc)."""
    port = params_from_jax(flat)
    vae = SpritesVAE(L=port["vae"]["enc_out.bias"].shape[0] // 2)
    vae.load_state_dict(port["vae"])
    repr_net = SpritesReprNet(L=port["repr"]["convs.0.bias"].shape[0])
    repr_net.load_state_dict(port["repr"])
    gp = SpritesSVGP(config=config, L_action=L_action,
                     use_se_kernel=use_se_kernel, **port["gp"])
    if gp.gplvm_action.shape[1] != L_action:
        raise ValueError(f"L_action {L_action} does not match the GPLVM "
                         f"table {tuple(gp.gplvm_action.shape)}")
    out = {"vae": vae, "repr": repr_net, "gp": gp}
    dense = _module(flat, "head/params").get("Dense_0")
    if dense is not None:
        kernel = dense["kernel"]  # (in, classes)
        head = ClassificationHead(*kernel.shape)
        head.load_state_dict({"dense.weight": _t(kernel.T),
                              "dense.bias": _t(dense["bias"])})
        out["head"] = head
    return out


def _hwc_rows(w: np.ndarray, side: int, f: int) -> np.ndarray:
    """A Dense kernel's first side*side*f rows from flax's (h, w, c)
    flatten order to torch's (c, h, w); any rows after them stay."""
    n = side * side * f
    head = w[:n].reshape(side, side, f, -1).transpose(2, 0, 1, 3)
    return np.concatenate([head.reshape(n, -1), w[n:]])


def _hwc_cols(w: np.ndarray, side: int, f: int) -> np.ndarray:
    """A Dense kernel's (or bias's) last axis from flax's (h, w, c)
    reshape order to torch's (c, h, w)."""
    lead = w.shape[:-1]
    return w.reshape(*lead, side, side, f).swapaxes(-1, -3).swapaxes(
        -1, -2).reshape(w.shape)


def _linear(dense: Dict[str, np.ndarray], name: str, rows=None,
            cols=None) -> dict:
    """{name.weight, name.bias} of a torch Linear from a flax Dense,
    with its rows (inputs) and/or columns (outputs) reordered as
    `rows(kernel)` / `cols(kernel or bias)`."""
    kernel, bias = dense["kernel"], dense["bias"]
    if rows is not None:
        kernel = rows(kernel)
    if cols is not None:
        kernel, bias = cols(kernel), cols(bias)
    return {f"{name}.weight": _t(kernel.T), f"{name}.bias": _t(bias)}


def _convs(p, names, prefix: str) -> dict:
    state = {}
    for i, name in enumerate(names):
        state[f"{prefix}.{i}.weight"] = _conv(p[name]["kernel"])
        state[f"{prefix}.{i}.bias"] = _t(p[name]["bias"])
    return state


def mnist_decoder_state(p: Dict[str, Dict[str, np.ndarray]],
                        prefix: str = "decoder/") -> dict:
    """dec_in / dec_convs of the MNIST decoder (nn.nets.mnist_decoder_layers),
    converted from flax's MnistDecoder params under `prefix` (Dense_0,
    Conv_0..2).
    The decoder reshapes its Dense output to (4, 4, 8) NHWC; torch
    reshapes (c, h, w), so the Dense columns are permuted."""
    f = p[prefix + "Conv_0"]["bias"].shape[0]
    state = _convs(p, [f"{prefix}Conv_{i}" for i in range(3)], "dec_convs")
    state.update(_linear(p[prefix + "Dense_0"], "dec_in",
                         cols=lambda w: _hwc_cols(w, 4, f)))
    return state


def mnist_vae_state(p: Dict[str, Dict[str, np.ndarray]]) -> dict:
    """State dict of nn.nets.MnistVAE from the flax MnistVAE params
    ({"encoder/Conv_0": {...}, ..., "decoder/Dense_0": {...}}).

    The encoder flattens (2, 2, 8) NHWC maps in (h, w, c) order; torch
    flattens (c, h, w), so the Dense rows are permuted (the decoder's
    columns likewise, see mnist_decoder_state).
    """
    f = p["encoder/Conv_0"]["bias"].shape[0]
    state = _convs(p, [f"encoder/Conv_{i}" for i in range(3)], "enc_convs")
    state.update(_linear(p["encoder/Dense_0"], "enc_out",
                         rows=lambda w: _hwc_rows(w, 2, f)))
    state.update(mnist_decoder_state(p))
    return state


def mnist_params_from_jax(flat: Dict[str, np.ndarray]) -> dict:
    """Flat JAX rotated-MNIST SVGPVAE parameters -> the port's (see the
    module doc).  A tree without gp/ leaves (a plain VAE run) gives the
    VAE alone."""
    vae = mnist_vae_state(_module(flat, "vae/params"))
    if not any(k.startswith("gp/") for k in flat):
        return {"vae": vae}
    missing = [f"gp/{k}" for k in MNIST_GP_FIELDS if f"gp/{k}" not in flat]
    if missing:
        raise KeyError(f"missing GP parameters: {missing}")
    gp = {k: _t(flat[f"gp/{k}"]) for k in MNIST_GP_FIELDS}
    if "gp/object_vectors" in flat:
        gp["object_vectors"] = _t(flat["gp/object_vectors"])
    return {"vae": vae, "gp": gp}


def cvae_params_from_jax(flat: Dict[str, np.ndarray]) -> dict:
    """Flat JAX MNIST CVAE parameters ({"vae": flax MnistCVAE params}:
    vae/params/enc_conv0/kernel, ..., enc_out, dec_in, dec_conv0..2) ->
    {"vae": nn.nets.MnistCVAE state dict}.  The encoder's Dense takes the
    (2, 2, 8) flatten and then [sin, cos]: only its first 32 rows are
    permuted; the decoder's Dense columns as in mnist_decoder_state."""
    p = _module(flat, "vae/params")
    f = p["enc_conv0"]["bias"].shape[0]
    state = _convs(p, [f"enc_conv{i}" for i in range(3)], "enc_convs")
    state.update(_convs(p, [f"dec_conv{i}" for i in range(3)], "dec_convs"))
    state.update(_linear(p["enc_out"], "enc_out",
                         rows=lambda w: _hwc_rows(w, 2, f)))
    state.update(_linear(p["dec_in"], "dec_in",
                         cols=lambda w: _hwc_cols(w, 4, f)))
    return {"vae": state}


def _gp_leaves(flat: Dict[str, np.ndarray], required, optional=()) -> dict:
    missing = [f"gp/{k}" for k in required if f"gp/{k}" not in flat]
    if missing:
        raise KeyError(f"missing GP parameters: {missing}")
    return {k: _t(flat[f"gp/{k}"]) for k in (*required, *optional)
            if f"gp/{k}" in flat}


SVIGP_GP_FIELDS = ("inducing_points", "length_scale", "amplitude", "q_mu",
                   "q_scale", "noise")
CASALE_GP_FIELDS = ("length_scale", "amplitude", "alpha", "object_vectors")


def svigp_params_from_jax(flat: Dict[str, np.ndarray]) -> dict:
    """Flat JAX deep-SVIGP parameters ({"dec": flax SVIGPDecoder params,
    "gp": SVIGP}: dec/params/decoder/Dense_0/kernel, ..., gp/q_mu, ...) ->
    {"dec": nn.nets.SVIGPDecoder state dict, "gp": {field: tensor}} for
    gp.svigp.SVIGP (the GPLVM table gp/object_vectors is optional)."""
    return {"dec": mnist_decoder_state(_module(flat, "dec/params")),
            "gp": _gp_leaves(flat, SVIGP_GP_FIELDS, ("object_vectors",))}


def casale_params_from_jax(flat: Dict[str, np.ndarray]) -> dict:
    """Flat JAX Casale GPVAE parameters ({"vae": flax MnistVAE params,
    "gp": CasaleGP}) -> {"vae": MnistVAE state dict, "gp": {field:
    tensor}} for gp.casale.CasaleGP."""
    return {"vae": mnist_vae_state(_module(flat, "vae/params")),
            "gp": _gp_leaves(flat, CASALE_GP_FIELDS)}


BALL_GP_FIELDS = (("inducing_points", "length_scale"),
                  ("length_scale_x", "length_scale_y"))


def ball_mlp_state(p: Dict[str, Dict[str, np.ndarray]]) -> dict:
    """State dict of nn.nets.BallEncoder / BallDecoder from the flax MLP
    params ({"Dense_0": ..., ..., "Dense_k": ...}): the first k Dense
    layers are the hidden ones, the last the head; flax kernels (in, out)
    become torch weights (out, in)."""
    n = len(p)
    state = {}
    for i in range(n):
        name = "out" if i == n - 1 else f"hidden.{i}"
        state[f"{name}.weight"] = _t(p[f"Dense_{i}"]["kernel"].T)
        state[f"{name}.bias"] = _t(p[f"Dense_{i}"]["bias"])
    return state


def ball_params_from_jax(flat: Dict[str, np.ndarray]) -> dict:
    """Flat JAX moving-ball parameters -> the port's (see the module
    doc)."""
    out = {"enc": ball_mlp_state(_module(flat, "enc/params")),
           "dec": ball_mlp_state(_module(flat, "dec/params"))}
    gp_keys = {k[3:] for k in flat if k.startswith("gp/")}
    if gp_keys:
        if gp_keys not in [set(f) for f in BALL_GP_FIELDS]:
            raise KeyError(f"unknown ball GP parameters: {sorted(gp_keys)}")
        out["gp"] = {k: _t(flat[f"gp/{k}"]) for k in sorted(gp_keys)}
    return out
