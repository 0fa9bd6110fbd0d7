"""SVGPVAE passes (port of svgpvae_tpu/models/svgpvae.py): the training
forward (Hensman or Titsias bound, optionally GECO) of rotated MNIST and
of SPRITES (aux data from the repr net, under autograd), the rotated-MNIST
conditional generation, and the SPRITES test-time passes (encode,
full-train-set precompute, conditional generation for unseen characters,
under no_grad).

Under --data_parallel (parallel.sharded) the training forward takes this
rank's rows of the global batch: the GP blocks sum their statistics
across ranks, the cross-entropy and reconstruction sums go through
parallel.psum, and b in GECO's moving average and the KL's b / N weight
is the global batch, so the objective and the GECO state are the global
batch's, replicated on every rank.  The SPRITES character means add each
rank's per-character sums across ranks (a rank's share may end inside a
character).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from svgpvae_tpu_torch import gp as gpm
from svgpvae_tpu_torch import linalg, parallel
from svgpvae_tpu_torch.utils.profiling import annotate

# q-network variance clip range (reference: SVGPVAE_model.py:858-859)
QVAR_CLIP = (1e-3, 10.0)
# GP posterior variance clip for SPRITES (reference: SVGPVAE_model.py:891-892)
PVAR_CLIP = (1e-4, 100.0)
# f32 guard on the MNIST posterior variance before the CE log
MNIST_PVAR_FLOOR = 1e-6

GP_BLOCK_IMPLS = ("reference", "fused", "fused_pallas", "fused_rejitter",
                  "fused_rejitter_pallas")

# --gp_block_impl 'auto': (workload, bound, backend) -> (impl, reason).
# Only the cells of the paths the port has are here.  The JAX table's
# "tpu" column becomes "cuda": on a CUDA device the north-star step runs
# the fused block with the hand-written B1 kernel (a `*_pallas` impl means
# "B1's kernel on a CUDA tensor, its plain twin on a CPU tensor"), as the
# SPRITES serving slice runs B2/B3 unconditionally on CUDA.
GP_BLOCK_AUTO_TABLE = {
    ("mnist", "hensman", "cuda"): (
        "fused_pallas", "one (17, 32, 32) B1 launch per step replaces the "
        "batched Cholesky and its solves; the slice's kernel path"),
    ("mnist", "hensman", "other"): (
        "reference", "two-pass path, the parity anchor (as the JAX CPU "
        "cell)"),
    # SPRITES: never an identity-KL impl (fused / fused_pallas).  The
    # product-of-linear kernel is rank-deficient at m = 72, where the
    # closed-form KL departs from the two-pass rejittered KL (PARITY.md
    # #10); the rejittered block takes logdet A_hat from a second B1 call.
    ("sprites", "hensman", "cuda"): (
        "fused_rejitter_pallas", "two B1 launches per step, (65, 72, 72) "
        "and (64, 72, 72) for A_hat; null-space-safe KL; the slice's kernel "
        "path"),
    ("sprites", "hensman", "other"): (
        "reference", "two-pass parity anchor (as the JAX CPU cell)"),
    # Titsias: the determinant-lemma block everywhere (gp_block_titsias),
    # never the dense two-pass bound, whose fp32 covariance goes
    # indefinite once training drives K_mm's spectrum hard (PARITY.md
    # #11/#12).
    ("mnist", "titsias", "cuda"): (
        "fused_pallas", "mirrors JAX (mnist, titsias, tpu); one (33, 32, 32) "
        "B1 launch per step; tests/test_torch_titsias.py::"
        "test_fused_block_matches_jax[pallas-mnist]"),
    ("mnist", "titsias", "other"): (
        "fused", "mirrors JAX (mnist, titsias, other); tests/"
        "test_torch_titsias.py::test_fused_block_matches_jax[chol-mnist]"),
    # SPRITES: the Cholesky Woodbury block, as JAX: on the rank-deficient
    # product-linear K_mm (m = 72) the explicit-inverse block corrupted
    # p_m in JAX (svgpvae_tpu/models/svgpvae.py:68-74).  An explicit
    # --gp_block_impl fused_pallas is still honoured.
    ("sprites", "titsias", "cuda"): (
        "fused", "mirrors JAX (sprites, titsias, tpu); tests/"
        "test_torch_titsias.py::test_fused_block_matches_jax[chol-sprites]"),
    ("sprites", "titsias", "other"): (
        "fused", "mirrors JAX (sprites, titsias, other); tests/"
        "test_torch_titsias.py::test_forward_pass_matches_jax"),
    # moving ball: the JAX table's cells (svgpvae_tpu/models/svgpvae.py:
    # 38-41, 64-67); one B1 launch per step on the whole flat stack
    ("ball", "hensman", "cuda"): (
        "fused_pallas", "mirrors JAX (ball, hensman, tpu); one (72, 15, 15) "
        "B1 launch per step, [K_mm; Sigma_1..35] per channel"),
    ("ball", "hensman", "other"): (
        "reference", "mirrors JAX (ball, hensman, other): the two-pass "
        "parity anchor"),
    ("ball", "titsias", "cuda"): (
        "fused_pallas", "mirrors JAX (ball, titsias, tpu); one (142, 15, 15) "
        "B1 launch per step, [K_mm; Sigma; Sigma1] per channel"),
    ("ball", "titsias", "other"): (
        "fused", "mirrors JAX (ball, titsias, other): the Woodbury block, "
        "never the dense fp32 bound"),
}


def resolve_gp_block_impl(impl: str, workload: str = "mnist",
                          titsias: bool = False,
                          device: torch.device = torch.device("cpu")) -> str:
    """Resolve 'auto' through GP_BLOCK_AUTO_TABLE by workload, bound and
    the device's backend; explicit impls pass through untouched."""
    if impl != "auto":
        if impl not in GP_BLOCK_IMPLS:
            raise ValueError(f"unknown gp_block_impl {impl!r}")
        return impl
    backend = "cuda" if torch.device(device).type == "cuda" else "other"
    key = (workload, "titsias" if titsias else "hensman", backend)
    if key not in GP_BLOCK_AUTO_TABLE:
        raise NotImplementedError(f"{key}: not ported yet")
    return GP_BLOCK_AUTO_TABLE[key][0]


class SVGPVAEOutputs(NamedTuple):
    elbo: Tensor            # objective (GECO: minimized; else maximized)
    recon_loss: Tensor      # per-pixel MSE sum (plain) / GECO constraint sum
    kl_term: Tensor
    inside_elbo: Tensor
    ce_term: Tensor
    p_m: Tensor
    p_v: Tensor
    qnet_mu: Tensor
    qnet_var: Tensor
    recon_images: Tensor
    inside_elbo_recon: Tensor
    inside_elbo_kl: Tensor
    latent_samples: Tensor
    C_ma: Tensor
    lagrange_mult: Tensor
    mean_vectors: Optional[Tensor] = None  # mu_hat (L, m) (see below)


def forward_pass_svgpvae(vae, gp_params, batch, eps: Tensor, beta, C_ma,
                         lagrange_mult, alpha, kappa, clip_qs: bool = True,
                         geco: bool = False, lagrange_max: float = 1e5,
                         gp_block_impl: str = "reference",
                         entropy_ce: bool = False, repr_net=None,
                         frames_per_char: int = 0,
                         titsias_reference_ce: bool = False,
                         bias_analysis: bool = False) -> SVGPVAEOutputs:
    """Training forward: encoder -> GP posterior + inside-ELBO (Hensman,
    or Titsias when gp_params.config.titsias) for all channels ->
    cross-entropy term -> reparameterized sample with the given `eps`
    (b, L) -> decoder -> objective.

    The Titsias inside-ELBO is the collapsed bound itself (no q(u) KL, no
    b/N scale), and its CE term is the exact entropy of N(p_m, p_v) unless
    `titsias_reference_ce` restores the reference's cross-entropy against
    the encoder Gaussian, which rewards their divergence where the
    Titsias bound has no data-fit term to cancel it (PARITY.md #13).
    `entropy_ce` takes the entropy for either bound.

    `bias_analysis` forces the two-pass block whatever `gp_block_impl`
    says and returns its mu_hat (L, m) as `mean_vectors`: the minibatch
    estimate of the q(u) mean that cli.mnist --bias_analysis averages
    over an epoch (JAX: the same forcing and reuse).  Without it
    `mean_vectors` is None (JAX's is a scalar 0 that nothing reads).

    batch = (images (b, 28, 28, 1) NHWC, aux_data (b, 2 + M)) for rotated
    MNIST, or (frames (b, 64, 64, 3), action ids (b,)) for SPRITES, where
    `repr_net` builds the rest of the aux data (sprites_aux_data, under
    autograd) from `frames_per_char` consecutive frames per character,
    and p_v is clipped to PVAR_CLIP (MNIST: floored at MNIST_PVAR_FLOOR).

    The nets may compute in bfloat16 (--bf16); the GP math stays in the
    images' dtype: the encoder's mean and variance and the SPRITES aux
    data are cast to it before the GP block, and the decoder's output
    before the pixel error (as JAX casts).  `eps` comes in p_m's dtype.

    GECO:
      recon = sum_b( mean_px_sq_err - kappa^2 )
      C_ma' = alpha * C_ma + (1 - alpha) * recon / b
      objective = -KL + lambda * (recon/b + detach(C_ma' - recon/b))
      lambda' = min(lambda * exp(C_ma'), lagrange_max)
    C_ma' and lambda' come back detached (the next step's state); alpha = 0
    at step 0 is the caller's (train.geco_effective_alpha).
    """
    if gp_block_impl not in GP_BLOCK_IMPLS:
        raise ValueError(f"gp_block_impl {gp_block_impl!r} ('auto' must be "
                         "resolved by the caller)")
    images, aux_data = batch
    b = parallel.global_rows(images.shape[0])
    K = images.shape[1] * images.shape[2] * images.shape[3]

    dtype = images.dtype
    qnet_mu, qnet_var = vae.encode(images)
    L = qnet_mu.shape[1]
    qnet_mu, qnet_var = qnet_mu.to(dtype), qnet_var.to(dtype)
    if clip_qs:
        qnet_var = torch.clamp(qnet_var, *QVAR_CLIP)
    if repr_net is not None:
        aux_data = sprites_aux_data(repr_net, images, aux_data,
                                    frames_per_char).to(dtype)

    titsias = gp_params.config.titsias
    inverse_impl = "pallas" if gp_block_impl.endswith("_pallas") else "chol"
    mu_hat = None
    with annotate("gp_block"):
        if gp_block_impl == "reference" or bias_analysis:
            p_m, p_v, mu_hat, A_hat = gpm.posterior_params(
                gp_params, aux_data, aux_data, qnet_mu, qnet_var)
            sum_terms, kl_terms = gpm.variational_loss(
                gp_params, aux_data, qnet_mu, qnet_var, mu_hat, A_hat)
        elif titsias:  # the rejitter distinction does not arise: no KL
            p_m, p_v, sum_terms, kl_terms, _ = gpm.gp_block_titsias(
                gp_params, aux_data, qnet_mu, qnet_var,
                inverse_impl=inverse_impl)
        else:
            p_m, p_v, sum_terms, kl_terms, _ = gpm.gp_block_hensman(
                gp_params, aux_data, qnet_mu, qnet_var,
                inverse_impl=inverse_impl,
                kl_impl="rejitter" if "rejitter" in gp_block_impl
                else "identity")

    inside_elbo_recon = torch.sum(sum_terms)
    inside_elbo_kl = torch.sum(kl_terms)
    if titsias:
        inside_elbo = inside_elbo_recon - inside_elbo_kl
    else:
        n_total = gp_params.config.N_train or b
        inside_elbo = inside_elbo_recon - (b / n_total) * inside_elbo_kl

    if repr_net is not None:  # numerical-stability clip (reference :891-892)
        p_v = torch.clamp(p_v, *PVAR_CLIP)
    else:  # f32 guard: Kxx - nystrom + sig_quad can dip slightly negative
        p_v = torch.clamp(p_v, min=MNIST_PVAR_FLOOR)

    if entropy_ce or (titsias and not titsias_reference_ce):
        # exact entropy of the sampling distribution N(p_m, p_v)
        ce_term = torch.sum(-0.5 * (1.0 + linalg.LOG_2PI + torch.log(p_v)))
    else:
        ce_term = torch.sum(linalg.gauss_cross_entropy(p_m, p_v, qnet_mu,
                                                       qnet_var))
    ce_term = parallel.psum(ce_term)
    kl_term = -ce_term + inside_elbo

    latent_samples = p_m + eps * linalg.stable_sqrt(p_v)
    recon_images = vae.decode(latent_samples)

    sq_err = (images - recon_images.to(dtype)) ** 2
    if geco:
        per_image_mse = torch.mean(sq_err, dim=(1, 2, 3))
        recon_loss = parallel.psum(torch.sum(per_image_mse - kappa * kappa))
        C_ma_new = (alpha * C_ma + (1.0 - alpha) * recon_loss / b).detach()
        elbo = -kl_term + lagrange_mult * (
            recon_loss / b + (C_ma_new - recon_loss / b).detach())
        lagrange_new = torch.clamp(lagrange_mult * torch.exp(C_ma_new),
                                   max=lagrange_max).detach()
    else:
        recon_loss = parallel.psum(torch.sum(sq_err)) / K
        elbo = -recon_loss + (beta / L) * kl_term
        C_ma_new, lagrange_new = C_ma, lagrange_mult

    return SVGPVAEOutputs(
        elbo=elbo, recon_loss=recon_loss, kl_term=kl_term,
        inside_elbo=inside_elbo, ce_term=ce_term, p_m=p_m, p_v=p_v,
        qnet_mu=qnet_mu, qnet_var=qnet_var, recon_images=recon_images,
        inside_elbo_recon=inside_elbo_recon, inside_elbo_kl=inside_elbo_kl,
        latent_samples=latent_samples, C_ma=C_ma_new,
        lagrange_mult=lagrange_new,
        mean_vectors=mu_hat if bias_analysis else None)


@torch.no_grad()
def predict_cgen_mnist(vae, gp_params, test_batch, train_means: Tensor,
                       train_vars: Tensor, aux_data_train: Tensor,
                       eps: Tensor):
    """Conditional generation for rotated MNIST: the GP posterior at the
    test aux data conditioned on ALL train encodings, sampled with `eps`
    (x, L), decoded.  Returns (recon images, per-pixel MSE sum)."""
    images_test, aux_test = test_batch
    K = images_test.shape[1] * images_test.shape[2]
    p_m, p_v, _, _ = parallel.sharded_posterior_params(
        gp_params, aux_test, aux_data_train, train_means, train_vars)
    recon = vae.decode(p_m + eps * linalg.stable_sqrt(p_v))
    return recon, torch.sum((images_test - recon) ** 2) / K


def sprites_aux_data(repr_net, images: Tensor, action_ids: Tensor,
                     frames_per_char: int) -> Tensor:
    """SPRITES auxiliary data: repr net -> per-character mean -> broadcast
    back to the frames -> prepend the action-id column, in the repr net's
    compute dtype (callers cast it for the GP).  The batch holds
    `frames_per_char` consecutive frames per character.  Differentiable
    (the training forward); test-time callers run it under no_grad.

    Inside parallel.sharded `images` is this rank's share of a global
    batch of whole characters, which may start or end inside one: each
    rank sums its frames' embeddings per global character, the sums are
    added across ranks, and every character's sum is divided by its
    frames_per_char frames."""
    emb = repr_net(images)  # (b, L_char)
    b, d = emb.shape
    if parallel.world() > 1:
        char = torch.div(torch.arange(b, device=emb.device)
                         + parallel.row_offset(b), frames_per_char,
                         rounding_mode="floor")  # global character ids
        sums = emb.new_zeros(parallel.global_rows(b) // frames_per_char,
                             d).index_add(0, char, emb)
        char_vecs = (parallel.psum(sums) / frames_per_char)[char]
    else:
        char_mean = emb.view(b // frames_per_char, frames_per_char,
                             d).mean(dim=1)
        char_vecs = torch.repeat_interleave(char_mean, frames_per_char,
                                            dim=0)
    return torch.cat([action_ids.to(emb.dtype)[:, None], char_vecs], dim=1)


@torch.no_grad()
def batching_encode_svgpvae(vae, images: Tensor, clip_qs: bool = True):
    """Encode a batch to (means, vars) for the test pipelines, in at
    least fp32 (they condition GP posteriors) whatever the encoder's
    compute dtype; the variance clip comes first, in that dtype, as in
    JAX."""
    qnet_mu, qnet_var = vae.encode(images)
    if clip_qs:
        qnet_var = torch.clamp(qnet_var, *QVAR_CLIP)
    dt = torch.promote_types(qnet_mu.dtype, torch.float32)
    return qnet_mu.to(dt), qnet_var.to(dt)


def precompute_gp_params(gp_params, means: Tensor, variances: Tensor,
                         aux_data: Tensor):
    """Full-train-set GP posterior precompute for the SPRITES test pipeline
    (each rank fits its share of the rows in a data-parallel run)."""
    return parallel.sharded_precompute_gp_params(gp_params, means,
                                                 variances, aux_data)


@torch.no_grad()
def predict_cgen_sprites(vae, gp_params, repr_net, images: Tensor,
                         action_ids: Tensor, mean_terms: Tensor,
                         Sigma_inv: Tensor, Kmm_inv: Tensor, n_context: int,
                         n_actions_total: int,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[Tensor] = None,
                         context_perm: Optional[Tensor] = None):
    """Conditional generation for unseen SPRITES characters.

    `images` holds batch/72 characters x 72 frames; the first `n_context`
    frames of each character form the context, the rest are the targets.
    `context_perm` (a per-character permutation of range(72)) reproduces
    the random-context variant.  The latent sample uses `eps` when given
    (parity tests inject the JAX draw), else a normal draw from
    `generator`.

    Returns (recon_target_images, target_images, recon_loss_sum_per_pixel).
    """
    b = images.shape[0]
    fpc = n_actions_total
    n_char = b // fpc
    K = images.shape[1] * images.shape[2] * images.shape[3]

    im = images.view(n_char, fpc, *images.shape[1:])
    aid = action_ids.view(n_char, fpc)
    if context_perm is not None:
        im = torch.take_along_dim(im, context_perm[..., None, None, None],
                                  dim=1)
        aid = torch.take_along_dim(aid, context_perm, dim=1)

    ctx_images = im[:, :n_context].reshape(-1, *images.shape[1:])
    tgt_images = im[:, n_context:].reshape(-1, *images.shape[1:])
    tgt_ids = aid[:, n_context:].reshape(-1)

    emb = repr_net(ctx_images)  # (n_char * n_context, d)
    char_mean = emb.view(n_char, n_context, -1).mean(dim=1)
    char_vecs = torch.repeat_interleave(char_mean, fpc - n_context, dim=0)
    aux_target = torch.cat([tgt_ids.to(emb.dtype)[:, None], char_vecs],
                           dim=1).to(images.dtype)  # GP math in fp32

    p_m, p_v = gpm.posterior_from_precomputed(
        gp_params, aux_target, mean_terms, Sigma_inv, Kmm_inv)
    # negative posterior variances occur on SPRITES (reference :1175-1177)
    p_v = torch.clamp(p_v, *PVAR_CLIP)

    if eps is None:
        eps = torch.randn(p_m.shape, generator=generator, dtype=p_m.dtype,
                          device=p_m.device)
    latent_samples = p_m + eps * linalg.stable_sqrt(p_v)

    recon = vae.decode(latent_samples)
    recon_loss = torch.sum((tgt_images - recon) ** 2) / K
    return recon, tgt_images, recon_loss
