"""Sparse variational GP core (port of svgpvae_tpu/gp/svgp.py: the MNIST
and SPRITES GP families, the two-pass batch-level Hensman and Titsias
math, and the test-time pipeline of both families).

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from svgpvae_tpu_torch import kernels, linalg
from svgpvae_tpu_torch.ops.fused_kernel_stats import fused_kernel_stats
from svgpvae_tpu_torch.ops.gp_stats import gp_stats, gp_sufficient_stats


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
    b = y.shape[0]
    scale = (cfg.N_train / b) if cfg.N_train else 1.0

    z = gp.inducing_points
    Kmm = gp.kmat(z, z)
    Kmm_chol = linalg.safe_cholesky(Kmm, cfg.jitter)
    Knm = gp.kmat(aux_train, z, x_inducing=False)  # (b, m)
    Kxm = gp.kmat(aux_test, z, x_inducing=False)   # (x, m)
    Kxx_diag = gp.kdiag(aux_test, aux_test, x_inducing=False,
                        y_inducing=False)          # (x,)

    precision = linalg.reciprocal_no_nan(noise)    # (b, L)
    sigma_contrib, r = gp_stats(Knm, precision, precision * y)
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
    return sum_terms, kl_terms


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
    Titsias bound when config.titsias, else of the Hensman bound."""
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
    """
    cfg = gp.config
    z = gp.inducing_points
    Kmm = gp.kmat(z, z)

    precision = linalg.reciprocal_no_nan(variances).contiguous()  # (N, L)
    # over the FULL train set: no N/b scaling
    sigma_contrib, r = _fused_precompute_stats(
        gp, aux_train, precision, (precision * means).contiguous())
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
