"""Sparse variational GP core (port of svgpvae_tpu/gp/svgp.py: the MNIST,
SPRITES and moving-ball GP families, the two-pass batch-level Hensman and
Titsias math, the two-pass per-video ball math, and the test-time
pipeline of the MNIST and SPRITES families).

Parameters are small dataclasses of tensors; all L latent channels are
processed at once with batched Cholesky factorizations.  The batch-level
sufficient statistics go through `ops.gp_stats.gp_stats` (B2 CUDA forward,
einsum backward); the full-train-set conditioning
(`precompute_test_posterior_terms`) runs B3 `fused_kernel_stats` for the
MNIST periodic x linear kernel and the SPRITES linear x linear kernel,
and B2 for the SPRITES SE kernel.  CPU tensors take the kernels' plain
twins.

Shapes: b = minibatch, m = #inducing points, L = #latent channels,
x = #query points, N = full-train size.

Under --data_parallel (parallel.sharded) the batch-level math takes this
rank's rows of the global batch: the (L, m, m) / (L, m) statistics and
the per-row sums go through parallel.psum, b in the N/b scale is the
global batch, and everything m-sized runs replicated on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from svgpvae_tpu_torch import kernels, linalg, parallel
from svgpvae_tpu_torch.ops.fused_kernel_stats import fused_kernel_stats
from svgpvae_tpu_torch.ops.gp_stats import (gp_stats, gp_sufficient_stats,
                                            gp_sufficient_stats_reference)


# Relative ridge of the Sigma_l factorization, scaled by Sigma's max
# diagonal: at SPRITES scale Sigma reaches ~1e7-1e8 and a fixed absolute
# jitter is meaningless in fp32 (svgpvae_tpu SVGPConfig.sigma_rel_jitter,
# whose default this is).
SIGMA_REL_JITTER = 1e-5


@dataclasses.dataclass(frozen=True)
class SVGPConfig:
    """Static GP configuration.  `titsias` selects the collapsed Titsias
    bound over the Hensman one; N_train > 0 enables the minibatch bias
    correction (N/b) of the batch-level SVGP."""

    titsias: bool = False
    jitter: float = 1e-6
    K_obj_normalize: bool = False
    N_train: int = 0
    # the reference ball-SVGP KL quirk: sum(A_hat * K_mm^-1 A_hat) in
    # place of mu_hat^T K_mm^-1 mu_hat (off: the correct KL)
    ball_kl_quirk: bool = False


def _named_tensors(obj) -> Dict[str, Tensor]:
    """{field: tensor} of a parameter dataclass (fields set to None, like
    an absent GPLVM table, are left out)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), Tensor)}


def _to(obj, *args, **kwargs):
    """A copy of a parameter dataclass with Tensor.to(*args, **kwargs)
    applied to every tensor field (device and/or dtype)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(*args, **kwargs)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), Tensor)})


@dataclasses.dataclass
class MnistSVGP:
    """Rotated-MNIST batch-level SVGP: product kernel = ExpSinSquared
    (period 2 pi) over the angle column x Linear over the M-dim object
    vector.  Object vectors come from the aux data (columns 2:) or, when
    the trainable GPLVM table is present, are gathered by the id column
    (column 0) -- inducing rows always carry their own."""

    config: SVGPConfig
    inducing_points: Tensor  # (m, 2 + M): [id, angle, obj...]
    length_scale: Tensor     # scalar
    amplitude: Tensor        # scalar
    object_vectors: Optional[Tensor] = None  # (n_objects, M) GPLVM table

    def _features(self, aux: Tensor, inducing: bool) -> Tuple[Tensor, Tensor]:
        view = aux[:, 1:2]
        if self.object_vectors is None or inducing:
            return view, aux[:, 2:]
        # float ids in column 0, truncated like the JAX astype(int32)
        return view, self.object_vectors[aux[:, 0].long()]

    def kmat(self, x: Tensor, y: Tensor, x_inducing: bool = True,
             y_inducing: bool = True) -> Tensor:
        xv, xo = self._features(x, x_inducing)
        yv, yo = self._features(y, y_inducing)
        k_view = kernels.exp_sin_squared_matrix(
            xv, yv, self.amplitude, self.length_scale, 2.0 * math.pi)
        k_obj = kernels.linear_matrix(xo, yo)
        if self.config.K_obj_normalize:
            k_obj = kernels.cosine_normalize_matrix(k_obj, xo, yo)
        return k_view * k_obj

    def kdiag(self, x: Tensor, y: Tensor, x_inducing: bool = True,
              y_inducing: bool = True) -> Tensor:
        xv, xo = self._features(x, x_inducing)
        yv, yo = self._features(y, y_inducing)
        k_view = kernels.exp_sin_squared_diag(
            xv, yv, self.amplitude, self.length_scale, 2.0 * math.pi)
        k_obj = kernels.linear_diag(xo, yo)
        if self.config.K_obj_normalize:
            k_obj = kernels.cosine_normalize_diag(k_obj, xo, yo)
        return k_view * k_obj

    named_tensors = _named_tensors
    to = _to


@dataclasses.dataclass
class SpritesSVGP:
    """SPRITES GP: aux rows are [action_id, character_repr...]; inducing
    rows are [action_vec (L_action), character_vec (L_character)].  Kernel
    = product of two linear kernels (optionally cosine-normalized) or, with
    `use_se_kernel`, of two RBF kernels."""

    config: SVGPConfig
    inducing_points: Tensor  # (m, L_action + L_character)
    gplvm_action: Tensor     # (n_actions, L_action) GPLVM table
    l_action: Tensor
    sigma_action: Tensor
    l_character: Tensor
    sigma_character: Tensor
    L_action: int = 6
    use_se_kernel: bool = False

    def _features(self, aux: Tensor, inducing: bool) -> Tuple[Tensor, Tensor]:
        if inducing:
            return aux[:, :self.L_action], aux[:, self.L_action:]
        # float ids in column 0, truncated like the JAX astype(int32)
        action = self.gplvm_action[aux[:, 0].long()]
        return action, aux[:, 1:]

    def kmat(self, x: Tensor, y: Tensor, x_inducing: bool = True,
             y_inducing: bool = True) -> Tensor:
        xa, xc = self._features(x, x_inducing)
        ya, yc = self._features(y, y_inducing)
        if self.use_se_kernel:
            k_a = kernels.rbf_matrix(xa, ya, self.l_action, self.sigma_action)
            k_c = kernels.rbf_matrix(xc, yc, self.l_character,
                                     self.sigma_character)
        else:
            k_a = kernels.linear_matrix(xa, ya)
            k_c = kernels.linear_matrix(xc, yc)
            if self.config.K_obj_normalize:
                k_a = kernels.cosine_normalize_matrix(k_a, xa, ya)
                k_c = kernels.cosine_normalize_matrix(k_c, xc, yc)
        return k_a * k_c

    def kdiag(self, x: Tensor, y: Tensor, x_inducing: bool = True,
              y_inducing: bool = True) -> Tensor:
        xa, xc = self._features(x, x_inducing)
        ya, yc = self._features(y, y_inducing)
        if self.use_se_kernel:
            k_a = kernels.rbf_diag(xa, ya, self.l_action, self.sigma_action)
            k_c = kernels.rbf_diag(xc, yc, self.l_character,
                                   self.sigma_character)
        else:
            k_a = kernels.linear_diag(xa, ya)
            k_c = kernels.linear_diag(xc, yc)
            if self.config.K_obj_normalize:
                k_a = kernels.cosine_normalize_diag(k_a, xa, ya)
                k_c = kernels.cosine_normalize_diag(k_c, xc, yc)
        return k_a * k_c

    named_tensors = _named_tensors
    to = _to


@dataclasses.dataclass
class BallSVGP:
    """Per-latent-channel sparse GP over 1-D time, parameters stacked over
    the C latent channels (C = 2 for the moving ball): an RBF kernel of
    unit amplitude per channel."""

    config: SVGPConfig
    inducing_points: Tensor  # (C, m)
    length_scale: Tensor     # (C,)

    def channel_kmat(self, x: Tensor, y: Tensor) -> Tensor:
        """x (C, n) or (n,), y (C, p) or (p,) -> (C, n, p), channel c with
        length_scale[c]; the ||x||^2 - 2xy + ||y||^2 expansion clamped at
        0, as kernels.rbf_matrix."""
        x = x.expand(self.length_scale.shape[0], -1) if x.dim() == 1 else x
        y = y.expand(self.length_scale.shape[0], -1) if y.dim() == 1 else y
        d2 = (x * x)[:, :, None] - 2.0 * (x[:, :, None] * y[:, None, :]) \
            + (y * y)[:, None, :]
        ls = self.length_scale[:, None, None]
        return torch.exp(-0.5 * torch.clamp(d2, min=0.0) / (ls * ls))

    named_tensors = _named_tensors
    to = _to


def init_ball_svgp(num_inducing: int, tmin: float, tmax: float,
                   length_scale_init: float, n_channels: int = 2,
                   config: SVGPConfig = SVGPConfig(),
                   dtype=torch.float32) -> BallSVGP:
    """A linspace inducing grid per channel."""
    ip = torch.linspace(tmin, tmax, num_inducing, dtype=dtype)
    return BallSVGP(config=config,
                    inducing_points=ip[None, :].repeat(n_channels, 1),
                    length_scale=torch.full((n_channels,), length_scale_init,
                                            dtype=dtype))


def init_mnist_svgp(initial_inducing_points, object_vectors_init=None,
                    config: SVGPConfig = SVGPConfig(),
                    dtype=torch.float32) -> MnistSVGP:
    def t(x):
        return torch.as_tensor(x, dtype=dtype)

    return MnistSVGP(
        config=config, inducing_points=t(initial_inducing_points),
        length_scale=t(1.0), amplitude=t(1.0),
        object_vectors=None if object_vectors_init is None
        else t(object_vectors_init))


def init_sprites_svgp(initial_inducing_points, initial_gplvm_action,
                      L_action: int, use_se_kernel: bool = False,
                      config: SVGPConfig = SVGPConfig(),
                      dtype=torch.float32) -> SpritesSVGP:
    def t(x):
        return torch.as_tensor(x, dtype=dtype)

    return SpritesSVGP(
        config=config,
        inducing_points=t(initial_inducing_points),
        gplvm_action=t(initial_gplvm_action),
        l_action=t(1.0), sigma_action=t(0.1),
        l_character=t(1.0), sigma_character=t(0.1),
        L_action=L_action, use_se_kernel=use_se_kernel)


def on_plain_path(t: Tensor) -> bool:
    """A float64 CUDA tensor (cli.mnist --x64).  The kernels take fp32
    only, and their wrappers launch or raise on a CUDA tensor, so the GP
    blocks call the kernels' plain PyTorch versions for it themselves.
    CPU tensors go to the wrappers, which run those versions there."""
    return t.is_cuda and t.dtype == torch.float64


def stats(Knm: Tensor, precision: Tensor, py: Tensor):
    """B2's autograd form `gp_stats`, or on the plain path its plain
    version (differentiable as it stands)."""
    if on_plain_path(Knm):
        return gp_sufficient_stats_reference(Knm, precision, py)
    return gp_stats(Knm, precision, py)


def relative_ridge(stack: Tensor):
    """SIGMA_REL_JITTER x the max diagonal over ALL matrices of the stack
    (as the JAX package: the f32 assembly's round-off scales with
    lambda_max)."""
    return SIGMA_REL_JITTER * torch.max(torch.diagonal(stack, dim1=-2,
                                                       dim2=-1))


def sigma_jitter(Sigma: Tensor, cfg: SVGPConfig):
    """Absolute + relative ridge of the Sigma_l factorization."""
    return cfg.jitter + relative_ridge(Sigma)


def _sigma_cholesky(Sigma: Tensor, cfg: SVGPConfig) -> Tensor:
    return linalg.safe_cholesky(Sigma, sigma_jitter(Sigma, cfg))


# ---------------------------------------------------------------------------
# batch-level two-pass math (the parity anchor, and the CPU default)
# ---------------------------------------------------------------------------


@linalg.precise
def kernel_matrices(gp, aux: Tensor):
    """The per-step kernel bundle, shared across the L channels:
    (Kmm, Kmm_chol, Knm, Knn_diag)."""
    z = gp.inducing_points
    Kmm = gp.kmat(z, z)
    Kmm_chol = linalg.safe_cholesky(Kmm, gp.config.jitter)
    Knm = gp.kmat(aux, z, x_inducing=False)
    Knn_diag = gp.kdiag(aux, aux, x_inducing=False, y_inducing=False)
    return Kmm, Kmm_chol, Knm, Knn_diag


@linalg.precise
def posterior_params(gp, aux_test: Tensor, aux_train: Tensor, y: Tensor,
                     noise: Tensor):
    """Approximate GP posterior for ALL channels.

    aux_test (x, D) index points to evaluate at, aux_train (b, D)
    minibatch index points, y/noise (b, L) encoder means/variances.
    Returns p_m (x, L), p_v (x, L), mu_hat (L, m), A_hat (L, m, m).
    """
    cfg = gp.config
    b = parallel.global_rows(y.shape[0])
    scale = (cfg.N_train / b) if cfg.N_train else 1.0

    z = gp.inducing_points
    Kmm = gp.kmat(z, z)
    Kmm_chol = linalg.safe_cholesky(Kmm, cfg.jitter)
    Knm = gp.kmat(aux_train, z, x_inducing=False)  # (b, m)
    Kxm = gp.kmat(aux_test, z, x_inducing=False)   # (x, m)
    Kxx_diag = gp.kdiag(aux_test, aux_test, x_inducing=False,
                        y_inducing=False)          # (x,)

    precision = linalg.reciprocal_no_nan(noise)    # (b, L)
    sigma_contrib, r = parallel.psum(*stats(Knm, precision, precision * y))
    Sigma = Kmm[None] + scale * sigma_contrib
    Sigma_chol = _sigma_cholesky(Sigma, cfg)       # (L, m, m)
    sir = linalg.cho_solve(Sigma_chol, r[..., None])[..., 0]  # (L, m)

    p_m = scale * torch.einsum("xm,lm->xl", Kxm, sir)

    # Nystrom term diag(K_xm K_mm^{-1} K_mx), shared over channels
    KmmInv_Kmx = linalg.cho_solve(Kmm_chol, Kxm.T)                 # (m, x)
    nystrom = torch.sum(Kxm * KmmInv_Kmx.T, dim=-1)                # (x,)
    SigInv_Kmx = linalg.cho_solve(
        Sigma_chol, Kxm.T.expand(Sigma.shape[0], *Kxm.T.shape))    # (L, m, x)
    sig_quad = torch.einsum("xm,lmx->xl", Kxm, SigInv_Kmx)         # (x, L)
    p_v = (Kxx_diag - nystrom)[:, None] + sig_quad

    mu_hat = scale * (Kmm @ sir[..., None])[..., 0]                # (L, m)
    A_hat = Kmm[None] @ linalg.cho_solve(Sigma_chol,
                                         Kmm.expand(Sigma.shape))
    return p_m, p_v, mu_hat, A_hat


@linalg.precise
def hensman_terms(gp, Kmm_chol: Tensor, Knm: Tensor, Knn_diag: Tensor,
                  y: Tensor, noise: Tensor, mu_hat: Tensor, A_hat: Tensor):
    """Hensman inside-ELBO pieces for all channels at once:
    (sum_terms (L,), kl_terms (L,))."""
    cfg = gp.config
    b = y.shape[0]

    W = linalg.cho_solve(Kmm_chol, Knm.T)            # (m, b)
    precision = linalg.reciprocal_no_nan(noise)      # (b, L)
    mean_vec = torch.einsum("mb,lm->bl", W, mu_hat)  # (b, L)
    k_tilde = Knn_diag - torch.sum(Knm * W.T, dim=-1)             # (b,)
    wAw = torch.einsum("mb,lmp,pb->bl", W, A_hat, W)              # (b, L)

    sum_terms = -0.5 * (
        torch.sum(precision * k_tilde[:, None], dim=0)
        + torch.sum(precision * wAw, dim=0)
        + torch.sum(torch.log(noise), dim=0)
        + b * linalg.LOG_2PI
        + torch.sum(precision * (y - mean_vec) ** 2, dim=0))     # (L,)
    kl_terms = linalg.mvn_kl_against_prior(mu_hat, A_hat, Kmm_chol,
                                           cfg.jitter)            # (L,)
    return parallel.psum(sum_terms), kl_terms


@linalg.precise
def titsias_terms(gp, Kmm_chol: Tensor, Knm: Tensor, Knn_diag: Tensor,
                  y: Tensor, noise: Tensor):
    """Titsias collapsed-bound inside-ELBO for all channels, through the
    dense (L, b, b) covariance Q + diag(noise_l) (Q = Knm Kmm^-1 Kmn, the
    Nystrom gram shared across channels): (l2_terms (L,), zero KL (L,)).

    The Nystrom residual of the trace term is floored at its bound 0: in
    fp32 a near-singular Kmm makes diag(Q) overshoot Knn_diag, and with
    the encoder variances at their clip floor a negative trace rewards
    driving the kernel singular (PARITY.md #11)."""
    cfg = gp.config
    b = y.shape[0]
    W = linalg.cho_solve(Kmm_chol, Knm.T)                          # (m, b)
    Q = Knm @ W                                                    # (b, b)
    precision = linalg.reciprocal_no_nan(noise)                    # (b, L)

    cov = Q[None] + torch.diag_embed(noise.T)                      # (L, b, b)
    cov_chol = linalg.safe_cholesky(cov, cfg.jitter)
    logdet = linalg.logdet_from_chol(cov_chol)                     # (L,)
    alpha = linalg.cho_solve(cov_chol, y.T[..., None])[..., 0]     # (L, b)
    quad = torch.sum(y.T * alpha, dim=-1)                          # (L,)
    residual = torch.clamp(Knn_diag - torch.diagonal(Q), min=0.0)  # (b,)
    trace = torch.sum(precision * residual[:, None], dim=0)        # (L,)

    l2 = -0.5 * (b * linalg.LOG_2PI + logdet + quad + trace)
    return l2, torch.zeros_like(l2)


def variational_loss(gp, aux: Tensor, y: Tensor, noise: Tensor,
                     mu_hat: Tensor, A_hat: Tensor):
    """Per-channel inside-ELBO terms (sum_terms (L,), kl_terms (L,)) of the
    Titsias bound when config.titsias, else of the Hensman bound.  The
    Titsias bound's dense (L, b, b) covariance couples every row, so a
    data-parallel step gathers the global batch's rows for it first and
    every rank evaluates the whole bound."""
    if gp.config.titsias and parallel.world() > 1:
        aux, y, noise = parallel.gather_rows(aux, y, noise)
        with parallel.sharded(False):
            return variational_loss(gp, aux, y, noise, mu_hat, A_hat)
    _, Kmm_chol, Knm, Knn_diag = kernel_matrices(gp, aux)
    if gp.config.titsias:
        return titsias_terms(gp, Kmm_chol, Knm, Knn_diag, y, noise)
    return hensman_terms(gp, Kmm_chol, Knm, Knn_diag, y, noise, mu_hat, A_hat)


def _fused_precompute_stats(gp, aux_train: Tensor, precision: Tensor,
                            py: Tensor):
    """(Sigma contribution, r) over the full train set.  The MNIST kernel
    (its object features from the GPLVM table when the run has one) and
    SPRITES's linear x linear kernel go to the fused kernel B3 (K built
    in-kernel); the SE kernel builds K_nm here and goes to B2.  No size
    threshold: on CUDA the kernels always run."""
    z = gp.inducing_points
    if isinstance(gp, MnistSVGP):
        view, obj = gp._features(aux_train, inducing=False)
        return fused_kernel_stats(
            view.contiguous(), obj.contiguous(), z[:, 1:2].contiguous(),
            z[:, 2:].contiguous(), precision, py, amp=gp.amplitude,
            length_scale=gp.length_scale, family="mnist",
            normalize=gp.config.K_obj_normalize)
    if gp.use_se_kernel:
        Knm = gp.kmat(aux_train, z, x_inducing=False)  # (N, m)
        return gp_sufficient_stats(Knm.contiguous(), precision, py)
    act, chr_ = gp._features(aux_train, inducing=False)
    return fused_kernel_stats(
        act.contiguous(), chr_.contiguous(),
        z[:, :gp.L_action].contiguous(), z[:, gp.L_action:].contiguous(),
        precision, py, family="sprites",
        normalize=gp.config.K_obj_normalize)


@linalg.precise
def precompute_test_posterior_terms(gp, means: Tensor, variances: Tensor,
                                    aux_train: Tensor):
    """Full-train-set posterior precomputation for an MnistSVGP or a
    SpritesSVGP.

    means/variances: (N, L) encoder outputs over the ENTIRE train set.
    Returns (mean_terms (L, m), Sigma_inv (L, m, m), Kmm_inv (m, m)).
    Inside parallel.sharded the rows are this rank's share of the train
    set and the statistics are summed across ranks.
    """
    cfg = gp.config
    z = gp.inducing_points
    Kmm = gp.kmat(z, z)

    precision = linalg.reciprocal_no_nan(variances).contiguous()  # (N, L)
    # over the FULL train set: no N/b scaling
    sigma_contrib, r = parallel.psum(*_fused_precompute_stats(
        gp, aux_train, precision, (precision * means).contiguous()))
    Sigma = Kmm[None] + sigma_contrib  # (L, m, m)
    Sigma_chol = _sigma_cholesky(Sigma, cfg)
    eye = torch.eye(Kmm.shape[0], dtype=Kmm.dtype, device=Kmm.device)
    Sigma_inv = linalg.cho_solve(Sigma_chol, eye.expand(Sigma.shape))
    mean_terms = linalg.cho_solve(Sigma_chol, r[..., None])[..., 0]  # (L, m)

    Kmm_inv = linalg.psd_inverse(Kmm, cfg.jitter)
    return mean_terms, Sigma_inv, Kmm_inv


@linalg.precise
def posterior_from_precomputed(gp, aux_target: Tensor,
                               mean_terms: Tensor, Sigma_inv: Tensor,
                               Kmm_inv: Tensor):
    """Fast GP predictive posterior from the precomputed terms.
    Returns (p_m (x, L), p_v (x, L))."""
    z = gp.inducing_points
    Kbm = gp.kmat(aux_target, z, x_inducing=False)  # (x, m)
    Kbb_diag = gp.kdiag(aux_target, aux_target, x_inducing=False,
                        y_inducing=False)  # (x,)

    p_m = torch.einsum("xm,lm->xl", Kbm, mean_terms)
    nystrom = torch.sum(Kbm * (Kbm @ Kmm_inv), dim=-1)  # (x,)
    sig_quad = torch.einsum("xm,lmp,xp->xl", Kbm, Sigma_inv, Kbm)  # (x, L)
    p_v = (Kbb_diag - nystrom)[:, None] + sig_quad
    return p_m, p_v


# ---------------------------------------------------------------------------
# ball variant: per-video GPs over time, full posterior covariance
# ---------------------------------------------------------------------------


def _ball_kernels(gp: BallSVGP, times: Tensor):
    """(Kmm (C, m, m), Kmm_chol, Knm (C, T, m)); the Cholesky with the
    absolute jitter only (no relative ridge on the ball path)."""
    z = gp.inducing_points
    Kmm = gp.channel_kmat(z, z)
    return Kmm, linalg.safe_cholesky(Kmm, gp.config.jitter), \
        gp.channel_kmat(times, z)


@linalg.precise
def ball_posterior_params(gp: BallSVGP, times: Tensor, y: Tensor,
                          noise: Tensor):
    """Posterior of the moving-ball SVGP, every channel and video at once.

    times (T,) shared grid; y/noise (V, T, C).  Returns p_m (V, T, C), the
    full covariance p_cov (V, T, T, C), mu_hat (V, m, C) and A_hat
    (V, m, m, C).  No minibatch bias correction: each video is a complete
    dataset."""
    jitter = gp.config.jitter
    Kmm, Kmm_chol, Knm = _ball_kernels(gp, times)
    Knn = gp.channel_kmat(times, times)                    # (C, T, T)
    KmnT = Knm.transpose(-1, -2)                           # (C, m, T)
    yc, nc = y.permute(2, 0, 1), noise.permute(2, 0, 1)    # (C, V, T)
    prec = linalg.reciprocal_no_nan(nc)
    C, V, T = yc.shape
    m = Kmm.shape[-1]

    Sigma = Kmm[:, None] + KmnT[:, None] @ (prec[..., None] * Knm[:, None])
    Sigma_chol = linalg.safe_cholesky(Sigma, jitter)       # (C, V, m, m)
    r = (KmnT[:, None] @ (prec * yc)[..., None])[..., 0]   # (C, V, m)
    sir = linalg.cho_solve(Sigma_chol, r[..., None])[..., 0]
    SigInv_Kmn = linalg.cho_solve(Sigma_chol, KmnT[:, None].expand(
        C, V, m, T))                                       # (C, V, m, T)
    KmmInv_Kmn = linalg.cho_solve(Kmm_chol, KmnT)          # (C, m, T)
    p_m = (Knm[:, None] @ sir[..., None])[..., 0]          # (C, V, T)
    B = (Knn - Knm @ KmmInv_Kmn)[:, None] + Knm[:, None] @ SigInv_Kmn
    mu_hat = (Kmm[:, None] @ sir[..., None])[..., 0]       # (C, V, m)
    A_hat = Kmm[:, None] @ linalg.cho_solve(
        Sigma_chol, Kmm[:, None].expand(C, V, m, m))
    return (p_m.permute(1, 2, 0), B.permute(1, 2, 3, 0),
            mu_hat.permute(1, 2, 0), A_hat.permute(1, 2, 3, 0))


@linalg.precise
def ball_variational_loss(gp: BallSVGP, times: Tensor, y: Tensor,
                          noise: Tensor, mu_hat: Tensor, A_hat: Tensor):
    """Inside-ELBO of the ball SVGP per video and channel.

    y/noise (V, T, C); mu_hat (V, m, C); A_hat (V, m, m, C).  Returns
    (sum_terms (V, C), kl_terms (V, C)); under config.titsias the
    collapsed bound through the dense (T, T) covariance and a zero KL."""
    cfg = gp.config
    Kmm, Kmm_chol, Knm = _ball_kernels(gp, times)
    m = Kmm.shape[-1]
    W = linalg.cho_solve(Kmm_chol, Knm.transpose(-1, -2))   # (C, m, T)
    k_tilde = 1.0 - torch.sum(Knm * W.transpose(-1, -2), dim=-1)  # (C, T)
    yc, nc = y.permute(2, 0, 1), noise.permute(2, 0, 1)     # (C, V, T)
    prec = linalg.reciprocal_no_nan(nc)
    C, V, T = yc.shape

    if cfg.titsias:
        Q = Knm @ W                                          # (C, T, T)
        cov_chol = linalg.safe_cholesky(Q[:, None] + torch.diag_embed(nc),
                                        cfg.jitter)          # (C, V, T, T)
        logdet = linalg.logdet_from_chol(cov_chol)
        alpha = linalg.cho_solve(cov_chol, yc[..., None])[..., 0]
        quad = torch.sum(yc * alpha, dim=-1)
        # floored Nystrom residual (PARITY.md #11)
        trace = torch.sum(prec * torch.clamp(k_tilde, min=0.0)[:, None],
                          dim=-1)
        l2 = -0.5 * (T * linalg.LOG_2PI + logdet + quad + trace)
        return l2.T, torch.zeros_like(l2).T

    mu, A = mu_hat.permute(2, 0, 1), A_hat.permute(3, 0, 1, 2)
    mean_vec = torch.einsum("cmt,cvm->cvt", W, mu)
    wAw = torch.einsum("cmt,cvmp,cpt->cvt", W, A, W)
    sum_terms = -0.5 * (
        torch.sum(prec * k_tilde[:, None], dim=-1)
        + torch.sum(prec * wAw, dim=-1)
        + torch.sum(torch.log(nc), dim=-1) + T * linalg.LOG_2PI
        + torch.sum(prec * (yc - mean_vec) ** 2, dim=-1))    # (C, V)
    K_chol = Kmm_chol[:, None].expand(C, V, m, m)
    if cfg.ball_kl_quirk:
        # the reference's A_hat-quadratic term in place of mu's
        S_chol = linalg.safe_cholesky(A, cfg.jitter)
        KiA = linalg.cho_solve(K_chol, A)
        kl = 0.5 * (linalg.logdet_from_chol(K_chol)
                    - linalg.logdet_from_chol(S_chol) - m
                    + torch.diagonal(KiA, dim1=-2, dim2=-1).sum(dim=-1)
                    + torch.sum(A * KiA, dim=(-2, -1)))
    else:
        kl = linalg.mvn_kl_against_prior(mu, A, K_chol, cfg.jitter)
    return sum_terms.T, kl.T
