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
table gp/object_vectors is optional.
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
    a moving-ball tree (enc/..., dec/...) goes to ball_params_from_jax."""
    if any(k.startswith("enc/") for k in flat):
        return ball_params_from_jax(flat)
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


def mnist_vae_state(p: Dict[str, Dict[str, np.ndarray]]) -> dict:
    """State dict of nn.nets.MnistVAE from the flax MnistVAE params
    ({"encoder/Conv_0": {...}, ..., "decoder/Dense_0": {...}}).

    The encoder flattens (2, 2, 8) NHWC maps in (h, w, c) order and the
    decoder reshapes its Dense output to (4, 4, 8) NHWC; torch flattens
    and reshapes (c, h, w), so the Dense rows/columns are permuted.
    """
    state = {}
    for i in range(3):
        for side, name in (("encoder", "enc_convs"), ("decoder", "dec_convs")):
            conv = p[f"{side}/Conv_{i}"]
            state[f"{name}.{i}.weight"] = _conv(conv["kernel"])
            state[f"{name}.{i}.bias"] = _t(conv["bias"])
    f = p["encoder/Conv_0"]["bias"].shape[0]

    w = p["encoder/Dense_0"]["kernel"]  # (2*2*f, 2L) rows in (h, w, c) order
    w = w.reshape(2, 2, f, -1).transpose(2, 0, 1, 3).reshape(w.shape)
    state["enc_out.weight"] = _t(w.T)
    state["enc_out.bias"] = _t(p["encoder/Dense_0"]["bias"])

    w = p["decoder/Dense_0"]["kernel"]  # (L, 4*4*f) columns in (h, w, c)
    L = w.shape[0]
    w = w.reshape(L, 4, 4, f).transpose(0, 3, 1, 2).reshape(w.shape)
    state["dec_in.weight"] = _t(w.T)
    b = p["decoder/Dense_0"]["bias"].reshape(4, 4, f).transpose(2, 0, 1)
    state["dec_in.bias"] = _t(b.reshape(-1))
    return state


def mnist_params_from_jax(flat: Dict[str, np.ndarray]) -> dict:
    """Flat JAX rotated-MNIST SVGPVAE parameters -> the port's (see the
    module doc)."""
    missing = [f"gp/{k}" for k in MNIST_GP_FIELDS if f"gp/{k}" not in flat]
    if missing:
        raise KeyError(f"missing GP parameters: {missing}")
    gp = {k: _t(flat[f"gp/{k}"]) for k in MNIST_GP_FIELDS}
    if "gp/object_vectors" in flat:
        gp["object_vectors"] = _t(flat["gp/object_vectors"])
    return {"vae": mnist_vae_state(_module(flat, "vae/params")), "gp": gp}


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
