"""Serving: precompute-once conditional-generation predictors
(port of svgpvae_tpu/serving.py), for the rotated-MNIST
and SPRITES GP families.

  * `fit` — one pass over the encoded train set: fold the O(N) GP
    conditioning into (L, m) / (L, m, m) posterior terms (the CUDA
    sufficient-statistics kernels run here; in a data-parallel run each
    rank on its share of the rows, parallel.sharded_precompute_gp_params,
    as the JAX `fit` under a mesh);
  * `predict` — a function of the query auxiliary data only: GP posterior
    at the queries -> decode -> images;
  * `make_request_fn` — a request: its inputs (the aux queries, or what
    builds them: SPRITES's context frames and action ids) -> `predict`,
    on a CUDA device as one captured CUDA graph per input shape (JAX's
    jitted `predict`, one program per query shape).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
from torch import Tensor

from svgpvae_tpu_torch import gp as gpm
from svgpvae_tpu_torch import linalg, parallel
from svgpvae_tpu_torch.models.svgpvae import PVAR_CLIP
from svgpvae_tpu_torch.train import capture


@dataclasses.dataclass(frozen=True)
class CGenPredictor:
    """Frozen predictor state: GP params + precomputed posterior terms."""

    gp_params: Union[gpm.MnistSVGP, gpm.SpritesSVGP]
    mean_terms: Tensor  # (L, m)
    sigma_inv: Tensor   # (L, m, m)
    kmm_inv: Tensor     # (m, m)


@torch.no_grad()
def fit(gp_params, train_means: Tensor, train_vars: Tensor,
        aux_train: Tensor) -> CGenPredictor:
    """Fold the full-train-set conditioning into reusable posterior terms.
    train_means/train_vars: (N, L) encoder outputs; aux_train: (N, D)."""
    mt, si, ki = parallel.sharded_precompute_gp_params(
        gp_params, train_means, train_vars, aux_train)
    return CGenPredictor(gp_params=gp_params, mean_terms=mt, sigma_inv=si,
                         kmm_inv=ki)


def make_predict_fn(predictor: CGenPredictor, vae, sample: bool = True):
    """(aux_query (x, D), generator) -> (images, p_m, p_v).

    With sample=False the decoder consumes the posterior mean."""

    @torch.no_grad()
    def predict(aux_query: Tensor,
                generator: Optional[torch.Generator] = None):
        p_m, p_v = gpm.posterior_from_precomputed(
            predictor.gp_params, aux_query, predictor.mean_terms,
            predictor.sigma_inv, predictor.kmm_inv)
        p_v = torch.clamp(p_v, *PVAR_CLIP)
        if sample:
            eps = torch.randn(p_m.shape, generator=generator,
                              dtype=p_m.dtype, device=p_m.device)
            z = p_m + eps * linalg.stable_sqrt(p_v)
        else:
            z = p_m
        return vae.decode(z), p_m, p_v

    return predict


def make_request_fn(predictor: CGenPredictor, vae, device: torch.device,
                    sample: bool = True,
                    generator: Optional[torch.Generator] = None,
                    query_fn: Optional[Callable] = None,
                    captured: bool = False) -> capture.CallPerShape:
    """request(*inputs) -> (aux_query, images, p_m, p_v) on `device`:
    query_fn(*inputs) builds the aux queries (by default the one input is
    the aux query), then `predict` draws from `generator`.  Inputs are
    tensors on any device, or arrays.  With `captured` each shape of the
    inputs is one captured CUDA graph (capture.CallPerShape: the inputs
    copied into its static buffers before each replay), with `generator`
    (the device's default one when None) registered, so that every replay
    draws fresh noise, the draws an eager request would take."""
    predict = make_predict_fn(predictor, vae, sample=sample)
    query_fn = query_fn or (lambda aux_query: aux_query)
    if captured and sample and generator is None:
        index = torch.device(device).index
        generator = torch.cuda.default_generators[
            torch.cuda.current_device() if index is None else index]

    def body(*inputs):
        aux_query = query_fn(*inputs)
        return (aux_query, *predict(aux_query, generator))

    return capture.CallPerShape(body, device, [generator] if sample else [],
                                captured=captured)
