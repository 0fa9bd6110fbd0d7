"""Fused GP blocks for the SVGPVAE training step (port of the Hensman and
Titsias blocks of svgpvae_tpu/gp/fused.py).

In the training forward the posterior is evaluated AT the minibatch
points, so the two passes of the reference structure (`posterior_params`
then `variational_loss`, gp/svgp.py) share most of their quantities:

  mean_vector_l = K_nm K_mm^{-1} mu_hat_l = p_m(train points)
  w_i^T A_hat_l w_i = K_nm,i Sigma_l^{-1} K_mn,i = sig_quad(train)_il
  k_tilde = K_nn_diag - nystrom(train)

and the KL( N(mu_hat, A_hat) || N(0, K_mm) ) with A_hat = K Sigma^{-1} K
closes over the Sigma factorization alone (logdet A_hat = 2 logdet K_mm -
logdet Sigma_l, tr(K_mm^{-1} A_hat) = tr(Sigma_l^{-1} K_mm)).  What
remains per step is ONE inverse-or-factorization of the (L+1, m, m) stack
[K_mm; Sigma_1..L] plus matmuls.

`inverse_impl="pallas"` (the JAX name, kept so one argv drives both
drivers) takes explicit inverses and logdets of that stack from
`ops.chol_inverse.chol_inverse`: the hand-written CUDA kernel B1 on a
CUDA tensor, its plain Cholesky twin on a CPU tensor.  A float64 CUDA
stack (cli.mnist --x64) takes B1's and B2's plain versions, called here
(gp.svgp.on_plain_path): the kernels take fp32 only.  `"chol"` factorizes
with torch.linalg.cholesky and solves.  The jitter policy is that of the
two-pass path.

`gp_block_titsias` evaluates the collapsed Titsias bound through the
matrix determinant lemma and Woodbury on one more (L, m, m) stack, so the
dense (L, b, b) covariance of the two-pass bound never exists.

`ball_gp_block` and `ball_gp_block_titsias` are the same dedup for the
moving ball's per-video GPs over time: one (C (V+1), m, m) stack
[K_mm_c; Sigma_c1..cV] per step (Titsias: (C (2V+1), m, m), with
Sigma1), absolute jitter only, and the batch-mean posterior covariance
(the gp_cov diagnostic) through mean_v Sigma_v^-1.

Under --data_parallel (parallel.sharded) the Hensman and Titsias blocks
take this rank's rows of the global batch: B2 runs on them, Sigma's and
r's statistics and the per-row sums go through parallel.psum before B1's
stack is built, and b in the N/b scale is the global batch; the stack,
its inverse (B1) and the KL run replicated on every rank.  The ball
blocks need no sum: each video is its own GP.
"""

from __future__ import annotations

import torch
from torch import Tensor

from svgpvae_tpu_torch import linalg, parallel
from svgpvae_tpu_torch.gp.svgp import (on_plain_path, relative_ridge,
                                       sigma_jitter, stats)
from svgpvae_tpu_torch.ops.chol_inverse import (chol_inverse,
                                                chol_inverse_reference)

INVERSE_IMPLS = ("chol", "pallas")


def _inverse(M: Tensor):
    """B1's autograd form `chol_inverse`, or on the plain path its plain
    version."""
    if on_plain_path(M):
        return chol_inverse_reference(M)
    return chol_inverse(M)
KL_IMPLS = ("identity", "rejitter")


@linalg.precise
def gp_block_hensman(gp, aux: Tensor, y: Tensor, noise: Tensor,
                     inverse_impl: str = "chol", kl_impl: str = "identity"):
    """Posterior params + Hensman inside-ELBO terms in one pass.

    aux (b, D) minibatch index points; y/noise (b, L) encoder means /
    variances.  Returns (p_m (b, L), p_v (b, L), sum_terms (L,),
    kl_terms (L,), mu_hat (L, m)).

    kl_impl "identity" uses the closed-form logdet A_hat; "rejitter"
    materializes A_hat = Kmm Sigma^{-1} Kmm and refactorizes it with
    jitter (the exact two-pass KL; with inverse_impl="pallas" its logdet
    comes from a second chol_inverse call).
    """
    if inverse_impl not in INVERSE_IMPLS or kl_impl not in KL_IMPLS:
        raise ValueError(f"inverse_impl {inverse_impl!r}, kl_impl {kl_impl!r}")
    cfg = gp.config
    b, L = y.shape
    scale = (cfg.N_train / parallel.global_rows(b)) if cfg.N_train else 1.0

    z = gp.inducing_points
    m = z.shape[0]
    Kmm = gp.kmat(z, z)                                   # (m, m)
    Knm = gp.kmat(aux, z, x_inducing=False)               # (b, m)
    Knn_diag = gp.kdiag(aux, aux, x_inducing=False,
                        y_inducing=False)                 # (b,)

    precision = linalg.reciprocal_no_nan(noise)           # (b, L)
    sigma_contrib, r = parallel.psum(*stats(Knm, precision, precision * y))
    Sigma = Kmm[None] + scale * sigma_contrib             # (L, m, m)
    M = torch.cat([linalg.add_jitter(Kmm, cfg.jitter)[None],
                   linalg.add_jitter(Sigma, sigma_jitter(Sigma, cfg))])

    if inverse_impl == "pallas":
        Minv, logdets = _inverse(M)
        Kmm_inv, Sigma_inv = Minv[0], Minv[1:]
        logdet_K, logdet_S = logdets[0], logdets[1:]
        sir = torch.einsum("lmp,lp->lm", Sigma_inv, r)              # (L, m)
        W_ny = Kmm_inv @ Knm.T                                      # (m, b)
        SigInv_Kmn = torch.einsum("lmp,bp->lmb", Sigma_inv, Knm)    # (L, m, b)
        tr_SiK = torch.sum(Sigma_inv * Kmm[None], dim=(-2, -1))     # (L,)
    else:
        chol = linalg.safe_cholesky(M, 0.0)  # NaN, not an error, if not PD
        Kmm_chol, Sigma_chol = chol[0], chol[1:]
        logdet_K = linalg.logdet_from_chol(Kmm_chol)
        logdet_S = linalg.logdet_from_chol(Sigma_chol)
        sir = linalg.cho_solve(Sigma_chol, r[..., None])[..., 0]
        W_ny = linalg.cho_solve(Kmm_chol, Knm.T)
        SigInv_Kmn = linalg.cho_solve(Sigma_chol, Knm.T.expand(L, m, b))
        E = linalg.cho_solve(Sigma_chol, Kmm.expand(L, m, m))  # Sigma^-1 Kmm
        tr_SiK = torch.diagonal(E, dim1=-2, dim2=-1).sum(dim=-1)

    # posterior at the batch points (== the Hensman mean vector / wAw)
    p_m = scale * torch.einsum("bm,lm->bl", Knm, sir)       # (b, L)
    nystrom = torch.sum(Knm * W_ny.T, dim=-1)               # (b,)
    sig_quad = torch.einsum("bm,lmb->bl", Knm, SigInv_Kmn)  # (b, L)
    k_tilde = Knn_diag - nystrom                            # (b,)
    p_v = k_tilde[:, None] + sig_quad                       # (b, L)

    sum_terms = parallel.psum(-0.5 * (
        torch.sum(precision * k_tilde[:, None], dim=0)
        + torch.sum(precision * sig_quad, dim=0)
        + torch.sum(torch.log(noise), dim=0)
        + b * linalg.LOG_2PI
        + torch.sum(precision * (y - p_m) ** 2, dim=0)))   # (L,)

    mu_hat = scale * torch.einsum("mp,lp->lm", Kmm, sir)    # (L, m)

    if kl_impl == "rejitter" and inverse_impl == "pallas":
        A_hat = Kmm[None] @ (Sigma_inv @ Kmm.expand(L, m, m))
        # A_hat is symmetric, but the fp32 products leave its two
        # triangles apart by ~1e-4 relative (the explicit Sigma^-1 is not
        # symmetric), and with cond(A_hat + jitter) ~1e5 the logdet of
        # the full matrix (Gauss-Jordan: the kernel) and of its lower
        # triangle (Cholesky: the twin) then differ by up to ~0.3.  B1
        # takes a symmetric PD matrix: average the triangles.
        A_hat = 0.5 * (A_hat + A_hat.transpose(-1, -2))
        _, logdet_A = _inverse(linalg.add_jitter(A_hat, cfg.jitter))
        tr_KiA = torch.sum(Kmm_inv[None] * A_hat, dim=(-2, -1))
        quad_mu = torch.einsum("lm,mp,lp->l", mu_hat, Kmm_inv, mu_hat)
        kl_terms = 0.5 * (logdet_K - logdet_A - m + tr_KiA + quad_mu)
    elif kl_impl == "rejitter":
        A_hat = Kmm[None] @ E
        kl_terms = linalg.mvn_kl_against_prior(mu_hat, A_hat, Kmm_chol,
                                               cfg.jitter)
    else:
        quad = scale * scale * torch.einsum("lm,mp,lp->l", sir, Kmm, sir)
        kl_terms = 0.5 * (tr_SiK + quad - m - logdet_K + logdet_S)

    return p_m, p_v, sum_terms, kl_terms, mu_hat


@linalg.precise
def gp_block_titsias(gp, aux: Tensor, y: Tensor, noise: Tensor,
                     inverse_impl: str = "chol"):
    """Posterior params + Titsias inside-ELBO terms in one pass.

    With D'_l = diag(noise_l + jitter) (the dense path's jittered
    covariance) and Q = Knm Kmm_j^{-1} Kmn, Kmm_j = Kmm + jitter I:

        logdet(Q + D'_l) = sum_i log noise'_il + logdet Sigma1_l
                           - logdet Kmm_j
        y^T (Q + D'_l)^{-1} y = y^T D'^{-1} y - r'^T Sigma1_l^{-1} r'
            Sigma1_l = Kmm_j + Kmn D'^{-1} Knm,  r'_l = Kmn D'^{-1} y

    Sigma1 has no N/b scale (the bound is over the batch alone), and its
    ridge is the relative one only: Kmm_j already carries the absolute
    jitter.  The trace term takes the unjittered precision and the
    Nystrom residual floored at 0 (PARITY.md #11); p_v the unfloored one.

    The (2L+1, m, m) stack [Kmm_j; Sigma_1..L; Sigma1_1..L] is factorized
    (inverse_impl "chol") or inverted by ONE chol_inverse call ("pallas":
    B1 on a CUDA tensor, its twin on a CPU tensor).  The JAX package
    splits the "pallas" stack in two for the TPU's VMEM; B1 treats every
    matrix of a stack alone, so one call gives the same results.

    aux (b, D); y/noise (b, L).  Returns (p_m (b, L), p_v (b, L),
    l2_terms (L,), kl_terms == zeros (L,), mu_hat (L, m)).
    """
    if inverse_impl not in INVERSE_IMPLS:
        raise ValueError(f"inverse_impl {inverse_impl!r}")
    cfg = gp.config
    b, L = y.shape
    b_all = parallel.global_rows(b)
    scale = (cfg.N_train / b_all) if cfg.N_train else 1.0

    z = gp.inducing_points
    m = z.shape[0]
    Kmm = gp.kmat(z, z)                                   # (m, m)
    Knm = gp.kmat(aux, z, x_inducing=False)               # (b, m)
    Knn_diag = gp.kdiag(aux, aux, x_inducing=False,
                        y_inducing=False)                 # (b,)

    precision = linalg.reciprocal_no_nan(noise)           # (b, L)
    # the bound's statistics at the jittered noise
    noise_b = noise + cfg.jitter
    prec_b = linalg.reciprocal_no_nan(noise_b)            # (b, L)
    sigma_contrib, r, contrib_b, r_b = parallel.psum(
        *stats(Knm, precision, precision * y),
        *stats(Knm, prec_b, prec_b * y))
    Sigma = Kmm[None] + scale * sigma_contrib             # (L, m, m)
    Kmm_j = linalg.add_jitter(Kmm, cfg.jitter)
    Sigma1 = Kmm_j[None] + contrib_b                      # (L, m, m)
    M = torch.cat([Kmm_j[None],
                   linalg.add_jitter(Sigma, sigma_jitter(Sigma, cfg)),
                   linalg.add_jitter(Sigma1, relative_ridge(Sigma1))])

    if inverse_impl == "pallas":
        Minv, logdets = _inverse(M)
        Kmm_inv, Sigma_inv, Sigma1_inv = Minv[0], Minv[1:L + 1], Minv[L + 1:]
        logdet_K, logdet_S1 = logdets[0], logdets[L + 1:]
        sir = torch.einsum("lmp,lp->lm", Sigma_inv, r)              # (L, m)
        W = Kmm_inv @ Knm.T                                         # (m, b)
        SigInv_Kmn = torch.einsum("lmp,bp->lmb", Sigma_inv, Knm)    # (L, m, b)
        s1ir = torch.einsum("lmp,lp->lm", Sigma1_inv, r_b)          # (L, m)
    else:
        chol = linalg.safe_cholesky(M, 0.0)  # NaN, not an error, if not PD
        Kmm_chol, Sigma_chol, Sigma1_chol = chol[0], chol[1:L + 1], \
            chol[L + 1:]
        logdet_K = linalg.logdet_from_chol(Kmm_chol)
        logdet_S1 = linalg.logdet_from_chol(Sigma1_chol)
        sir = linalg.cho_solve(Sigma_chol, r[..., None])[..., 0]
        W = linalg.cho_solve(Kmm_chol, Knm.T)
        SigInv_Kmn = linalg.cho_solve(Sigma_chol, Knm.T.expand(L, m, b))
        s1ir = linalg.cho_solve(Sigma1_chol, r_b[..., None])[..., 0]

    # posterior at the batch points (as in the Hensman block)
    p_m = scale * torch.einsum("bm,lm->bl", Knm, sir)       # (b, L)
    nystrom = torch.sum(Knm * W.T, dim=-1)                  # (b,) == diag(Q)
    sig_quad = torch.einsum("bm,lmb->bl", Knm, SigInv_Kmn)  # (b, L)
    k_tilde = Knn_diag - nystrom                            # (b,)
    p_v = k_tilde[:, None] + sig_quad                       # (b, L)

    # the sums over the batch's rows
    logdet_D, quad_D, trace = parallel.psum(
        torch.sum(torch.log(noise_b), dim=0),
        torch.sum(prec_b * y * y, dim=0),
        torch.sum(precision * torch.clamp(k_tilde, min=0.0)[:, None],
                  dim=0))                                   # (L,) each
    logdet = logdet_D + logdet_S1 - logdet_K                # (L,)
    quad = quad_D - torch.sum(r_b * s1ir, dim=-1)           # (L,)
    l2_terms = -0.5 * (b_all * linalg.LOG_2PI + logdet + quad + trace)

    mu_hat = scale * torch.einsum("mp,lp->lm", Kmm, sir)    # (L, m)
    return p_m, p_v, l2_terms, torch.zeros_like(l2_terms), mu_hat


def _ball_assembly(gp, times: Tensor, y: Tensor, noise: Tensor):
    """Kmm (C, m, m), Knm (C, T, m), Knn (C, T, T), y/noise/precision as
    (C, V, T), and Sigma (C, V, m, m) / r (C, V, m) of every video."""
    z = gp.inducing_points
    Kmm, Knm, Knn = (gp.channel_kmat(z, z), gp.channel_kmat(times, z),
                     gp.channel_kmat(times, times))
    yc, nc = y.permute(2, 0, 1), noise.permute(2, 0, 1)
    prec = linalg.reciprocal_no_nan(nc)
    Sigma = Kmm[:, None] + torch.einsum("ctm,cvt,ctp->cvmp", Knm, prec, Knm)
    r = torch.einsum("ctm,cvt->cvm", Knm, prec * yc)
    return Kmm, Knm, Knn, yc, nc, prec, Sigma, r


def _ball_cov_mean(Knn, Knm, W, SigInv_Kmn):
    """mean_v B_v = Knn - Knm Kmm^-1 Kmn + Knm (mean_v Sigma_v^-1) Kmn,
    (C, T, T)."""
    return (Knn - torch.einsum("ctm,cms->cts", Knm, W)
            + torch.einsum("ctm,cms->cts", Knm, SigInv_Kmn.mean(dim=1)))


def _out(p_m, p_v, terms, kl, cov_mean):
    """(C, V, .) -> the (V, T, C) / (V, C) / (T, T, C) layouts."""
    return (p_m.permute(1, 2, 0), p_v.permute(1, 2, 0), terms.T, kl.T,
            cov_mean.permute(1, 2, 0))


@linalg.precise
def ball_gp_block(gp, times: Tensor, y: Tensor, noise: Tensor,
                  inverse_impl: str = "chol"):
    """Fused moving-ball GP block: posterior + Hensman inside-ELBO.

    The posterior is evaluated at the video's own time grid, so the loss's
    mean vector W^T mu_hat == Knm sir == p_m, w^T A_hat w == sig_quad, and
    the KL closes over Sigma (logdet A_hat = 2 logdet Kmm - logdet Sigma).
    kl_terms honours config.ball_kl_quirk.

    times (T,); y/noise (V, T, C).  Returns (p_m (V, T, C), p_v (V, T, C),
    sum_terms (V, C), kl_terms (V, C), gp_cov_mean (T, T, C)).  With
    inverse_impl="pallas" ONE chol_inverse call takes the flat
    (C (V+1), m, m) stack (B1 on a CUDA tensor)."""
    if inverse_impl not in INVERSE_IMPLS:
        raise ValueError(f"inverse_impl {inverse_impl!r}")
    cfg = gp.config
    Kmm, Knm, Knn, yc, nc, prec, Sigma, r = _ball_assembly(gp, times, y,
                                                           noise)
    C, V, T = yc.shape
    m = Kmm.shape[-1]
    M = torch.cat([linalg.add_jitter(Kmm, cfg.jitter)[:, None],
                   linalg.add_jitter(Sigma, cfg.jitter)], dim=1)
    KmnT = Knm.transpose(-1, -2)                          # (C, m, T)
    if inverse_impl == "pallas":
        Minv, lds = _inverse(M.reshape(C * (V + 1), m, m))
        Minv, lds = Minv.reshape(C, V + 1, m, m), lds.reshape(C, V + 1)
        Kmm_inv, Sigma_inv = Minv[:, 0], Minv[:, 1:]
        logdet_K, logdet_S = lds[:, 0], lds[:, 1:]
        sir = torch.einsum("cvmp,cvp->cvm", Sigma_inv, r)
        W = Kmm_inv @ KmnT
        SigInv_Kmn = torch.einsum("cvmp,ctp->cvmt", Sigma_inv, Knm)
        E = torch.einsum("cvmp,cpq->cvmq", Sigma_inv, Kmm)  # Sigma^-1 Kmm
    else:
        chol = linalg.safe_cholesky(M, 0.0)  # NaN, not an error, if not PD
        Kmm_chol, Sigma_chol = chol[:, 0], chol[:, 1:]
        logdet_K = linalg.logdet_from_chol(Kmm_chol)      # (C,)
        logdet_S = linalg.logdet_from_chol(Sigma_chol)    # (C, V)
        sir = linalg.cho_solve(Sigma_chol, r[..., None])[..., 0]
        W = linalg.cho_solve(Kmm_chol, KmnT)
        SigInv_Kmn = linalg.cho_solve(Sigma_chol,
                                      KmnT[:, None].expand(C, V, m, T))
        E = linalg.cho_solve(Sigma_chol, Kmm[:, None].expand(C, V, m, m))

    tr_SiK = torch.diagonal(E, dim1=-2, dim2=-1).sum(dim=-1)  # (C, V)
    p_m = torch.einsum("ctm,cvm->cvt", Knm, sir)          # (C, V, T)
    nystrom = torch.einsum("ctm,cmt->ct", Knm, W)         # (C, T)
    sig_quad = torch.einsum("ctm,cvmt->cvt", Knm, SigInv_Kmn)
    k_tilde = 1.0 - nystrom  # the unit-amplitude RBF's diagonal is 1
    p_v = k_tilde[:, None] + sig_quad                     # (C, V, T)

    sum_terms = -0.5 * (
        torch.einsum("cvt,ct->cv", prec, k_tilde)
        + torch.sum(prec * sig_quad, dim=-1)
        + torch.sum(torch.log(nc), dim=-1) + T * linalg.LOG_2PI
        + torch.sum(prec * (yc - p_m) ** 2, dim=-1))      # (C, V)

    # logdet K - logdet A_hat == logdet S - logdet K in both KL forms
    ld_gap = logdet_S - logdet_K[:, None]                 # (C, V)
    if cfg.ball_kl_quirk:
        # the reference's sum(A * Kmm^-1 A) = tr(Kmm E E)
        quirk_quad = torch.einsum("cmp,cvpq,cvqm->cv", Kmm, E, E)
        kl_terms = 0.5 * (ld_gap - m + tr_SiK + quirk_quad)
    else:
        quad = torch.einsum("cvm,cmp,cvp->cv", sir, Kmm, sir)
        kl_terms = 0.5 * (tr_SiK + quad - m + ld_gap)
    return _out(p_m, p_v, sum_terms, kl_terms,
                _ball_cov_mean(Knn, Knm, W, SigInv_Kmn))


@linalg.precise
def ball_gp_block_titsias(gp, times: Tensor, y: Tensor, noise: Tensor,
                          inverse_impl: str = "chol"):
    """Fused moving-ball Titsias block: posterior + the collapsed bound
    through the determinant lemma and Woodbury on Sigma1 = Kmm_j + Kmn
    D'^-1 Knm, D' = diag(noise + jitter) (the dense path's jittered
    covariance), batched over channels and videos.

    times (T,); y/noise (V, T, C).  Returns (p_m, p_v, l2_terms (V, C),
    zeros (V, C), gp_cov_mean (T, T, C)).  With inverse_impl="pallas"
    ONE chol_inverse call takes the flat (C (2V+1), m, m) stack
    [Kmm_j; Sigma; Sigma1] per channel."""
    if inverse_impl not in INVERSE_IMPLS:
        raise ValueError(f"inverse_impl {inverse_impl!r}")
    cfg = gp.config
    Kmm, Knm, Knn, yc, nc, prec, Sigma, r = _ball_assembly(gp, times, y,
                                                           noise)
    C, V, T = yc.shape
    m = Kmm.shape[-1]
    # the bound's statistics at the jittered noise
    nc_b = nc + cfg.jitter
    prec_b = linalg.reciprocal_no_nan(nc_b)
    Kmm_j = linalg.add_jitter(Kmm, cfg.jitter)
    Sigma1 = Kmm_j[:, None] + torch.einsum("ctm,cvt,ctp->cvmp", Knm, prec_b,
                                           Knm)
    r_b = torch.einsum("ctm,cvt->cvm", Knm, prec_b * yc)
    M = torch.cat([Kmm_j[:, None], linalg.add_jitter(Sigma, cfg.jitter),
                   Sigma1], dim=1)                        # (C, 2V+1, m, m)
    KmnT = Knm.transpose(-1, -2)
    if inverse_impl == "pallas":
        Minv, lds = _inverse(M.reshape(C * (2 * V + 1), m, m))
        Minv = Minv.reshape(C, 2 * V + 1, m, m)
        lds = lds.reshape(C, 2 * V + 1)
        Kmm_inv, Sigma_inv = Minv[:, 0], Minv[:, 1:V + 1]
        Sigma1_inv = Minv[:, V + 1:]
        logdet_K, logdet_S1 = lds[:, 0], lds[:, V + 1:]
        sir = torch.einsum("cvmp,cvp->cvm", Sigma_inv, r)
        W = Kmm_inv @ KmnT
        SigInv_Kmn = torch.einsum("cvmp,ctp->cvmt", Sigma_inv, Knm)
        s1ir = torch.einsum("cvmp,cvp->cvm", Sigma1_inv, r_b)
    else:
        chol = linalg.safe_cholesky(M, 0.0)  # NaN, not an error, if not PD
        Kmm_chol, Sigma_chol = chol[:, 0], chol[:, 1:V + 1]
        Sigma1_chol = chol[:, V + 1:]
        logdet_K = linalg.logdet_from_chol(Kmm_chol)      # (C,)
        logdet_S1 = linalg.logdet_from_chol(Sigma1_chol)  # (C, V)
        sir = linalg.cho_solve(Sigma_chol, r[..., None])[..., 0]
        W = linalg.cho_solve(Kmm_chol, KmnT)
        SigInv_Kmn = linalg.cho_solve(Sigma_chol,
                                      KmnT[:, None].expand(C, V, m, T))
        s1ir = linalg.cho_solve(Sigma1_chol, r_b[..., None])[..., 0]

    p_m = torch.einsum("ctm,cvm->cvt", Knm, sir)          # (C, V, T)
    nystrom = torch.einsum("ctm,cmt->ct", Knm, W)         # (C, T) == diag(Q)
    sig_quad = torch.einsum("ctm,cvmt->cvt", Knm, SigInv_Kmn)
    k_tilde = 1.0 - nystrom
    p_v = k_tilde[:, None] + sig_quad

    logdet = (torch.sum(torch.log(nc_b), dim=-1)
              + logdet_S1 - logdet_K[:, None])            # (C, V)
    quad = (torch.sum(prec_b * yc * yc, dim=-1)
            - torch.sum(r_b * s1ir, dim=-1))              # (C, V)
    # floored Nystrom residual (PARITY.md #11)
    trace = torch.einsum("cvt,ct->cv", prec, torch.clamp(k_tilde, min=0.0))
    l2_terms = -0.5 * (T * linalg.LOG_2PI + logdet + quad + trace)
    return _out(p_m, p_v, l2_terms, torch.zeros_like(l2_terms),
                _ball_cov_mean(Knn, Knm, W, SigInv_Kmn))
