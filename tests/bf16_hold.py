"""The bf16 tests' rule (tests/test_torch_bf16_*.py).  A port output at a
bfloat16 compute dtype has JAX's dtype, and

  * a tensor: its root-mean-square distance from JAX's bf16 output is at
    most HALF of the root-mean-square distance between JAX's bf16 and its
    fp32 output on the same input.  Both sides round where flax rounds,
    so they differ only where fp32 accumulations in other orders round a
    value to two neighbouring bf16 numbers: a few entries one bf16 ulp
    apart, where the bf16 rounding moves every entry.  The mean square
    weighs those few as few (a maximum would let one of them set the
    result); a port that computed in fp32 sits at JAX's whole distance
    and fails;
  * a scalar (a loss, a GECO state, each a sum over many bf16-rounded
    terms, whose bf16 and fp32 values can agree to round-off): within
    SCALAR_RTOL, half a bf16 ulp, of its magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from svgpvae_tpu_torch import ops

HALF = 0.5
SCALAR_RTOL = 2.0 ** -9
# XLA with its excess precision off rounds every op's result to its dtype,
# as flax's dtype= declares; its CPU backend's default keeps a fused bf16
# intermediate in fp32 (the exp of a bf16 log-variance cast to fp32 came
# out half a bf16 ulp from flax's rounding, 3.9e-3 at a scale of 1.8).
# Compiled at XLA's lowest optimisation level: a compile of a fraction of
# a second, where running the same program op by op (which rounds the
# same way) took 14 s.
FLAX_ROUNDING = {"xla_allow_excess_precision": False,
                 "xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}
TORCH_DTYPE = {np.dtype(jnp.bfloat16): torch.bfloat16,
               np.dtype(np.float32): torch.float32}


def flax_rounding(fn):
    """`fn` jitted and compiled with FLAX_ROUNDING, once per argument
    shapes and dtypes."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = str(jax.tree_util.tree_map(
            lambda a: (np.shape(a), np.result_type(a).name), args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=FLAX_ROUNDING)
        return compiled[key](*args)
    return call


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(x))))


def hold_to_jax_bf16(got, want_bf16, want_f32, what=""):
    """`got`'s dtype is JAX's (`want_bf16`'s), and `got` is held to
    `want_bf16` by the rule of the module doc (`want_f32`: JAX's fp32
    output on the same input).  Returns (err, limit)."""
    want_bf16 = np.asarray(want_bf16)
    assert got.dtype == TORCH_DTYPE[want_bf16.dtype], (what, got.dtype)
    g = got.detach().float().cpu().numpy().astype(np.float64)
    w = want_bf16.astype(np.float64)
    if w.size == 1:
        err, limit = float(np.abs(g - w).max()), SCALAR_RTOL * abs(float(w))
    else:
        r = np.asarray(want_f32).astype(np.float64)
        err, limit = rms(g - w), HALF * rms(w - r)
        assert limit > 0, what
    assert err <= limit, (what, err, limit)
    return err, limit


def grad_bias_summed_in_fp32(loss, params, vae_key="vae"):
    """jax.grad(loss)(params) (under flax_rounding), where `loss` applies
    a flax net at a bf16 `dtype=` on params[vae_key], with the gradient of
    each of its Dense and Conv biases taken as the fp32 sum of the layer's
    bf16 output cotangent over its leading axes, rounded once to bf16:
    torch's (and a TPU's) reduction, where XLA's CPU backend sums the
    cotangent in bf16 (each bias then sat as far from its own fp32
    gradient as the whole bf16 rounding moved it, 0.2 at a scale of 0.13).
    The cotangents are read as the gradients of zeros added to the
    layers' outputs through flax's method interceptor, which leaves the
    forward values as they are."""
    outputs = {}

    def is_biased(ctx):
        return (ctx.method_name == "__call__" and getattr(
            ctx.module, "use_bias", False) and isinstance(
                ctx.module, (flax_nn.Dense, flax_nn.Conv)))

    def record(next_fun, args, kwargs, ctx):
        y = next_fun(*args, **kwargs)
        if is_biased(ctx):
            outputs[ctx.module.path] = jax.ShapeDtypeStruct(y.shape, y.dtype)
        return y

    with flax_nn.intercept_methods(record):
        jax.eval_shape(loss, params)

    def probed(p, zeros):
        def add(next_fun, args, kwargs, ctx):
            y = next_fun(*args, **kwargs)
            return y + zeros[ctx.module.path] if is_biased(ctx) else y
        with flax_nn.intercept_methods(add):
            return loss(p)

    zeros = {k: jnp.zeros(s.shape, s.dtype) for k, s in outputs.items()}
    grads, cot = flax_rounding(jax.grad(probed, argnums=(0, 1)))(
        params, zeros)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    for path, dy in cot.items():
        node = grads[vae_key]["params"]
        for name in path:
            node = node[name]
        summed = np.asarray(dy, np.float32).reshape(-1, dy.shape[-1]).sum(0)
        node["bias"] = np.asarray(jnp.asarray(summed, jnp.bfloat16),
                                  np.float32)
    return grads


@pytest.fixture
def kernel_inputs():
    """The (name, dtype) of every tensor the GP modules hand to the
    kernels' wrappers during the test (ops.KernelInputRecorder)."""
    with ops.KernelInputRecorder() as rec:
        yield rec.seen


class ReprTrunk(flax_nn.Module):
    """svgpvae_tpu.nn.SpritesReprNet's three convs (its parameter names),
    without the pool: (b, 8, 8, L) in `dtype`."""
    L: int
    dtype: object

    @flax_nn.compact
    def __call__(self, images):
        h = images.astype(self.dtype)
        for i in range(3):
            h = flax_nn.elu(flax_nn.Conv(
                self.L, (2, 2), strides=(2, 2), padding="SAME",
                dtype=self.dtype, name=f"conv{i}")(h))
        return h


def repr_pooled_once(L: int):
    """apply(params, images) of the JAX package's SpritesReprNet at bf16
    with its 8x8 pool accumulated in fp32 and rounded to bf16 once, as
    torch (and a TPU's reduction) pools; XLA's CPU backend instead sums
    the 64 values one at a time in bf16 (tests/test_torch_bf16_nets.py)."""
    trunk = ReprTrunk(L, jnp.bfloat16)

    def apply(params, images):
        t = trunk.apply(params, images).astype(jnp.float32)
        return (t.reshape(t.shape[0], -1, L).sum(1) / 64).astype(
            jnp.bfloat16)
    return apply
