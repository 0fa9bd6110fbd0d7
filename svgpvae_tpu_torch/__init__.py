"""svgpvae_tpu_torch — the PyTorch/CUDA port of svgpvae_tpu for NVIDIA Hopper.

The JAX package `svgpvae_tpu` is the reference; each module here keeps the
name of its JAX counterpart, and the tests hold each against it.  This
package imports torch, numpy and scipy, never jax, flax, optax, orbax or
sklearn.

Ported so far:
  * the SPRITES serving path (encode the train split, build the character
    auxiliary data, fold the full-train-set GP conditioning into posterior
    terms with the CUDA sufficient-statistics kernels B2/B3, answer
    conditional-generation requests), cli/serve.py;
  * rotated-MNIST SVGPVAE training, Hensman bound with GECO (conv VAE,
    the periodic x linear GPLVM kernel, the fused GP block with the CUDA
    inverse/logdet kernel B1 and B2 under autograd, Adam), with its
    eval, test and conditional-generation passes, cli/mnist.py;
  * SPRITES training, the Titsias bound on both trainers, run dirs,
    checkpoints and serving from a run, cli/sprites.py and cli/serve.py;
  * the moving-ball family (the SVGPVAE under both bounds with B1 on the
    per-video stacks, and the exact-GP Pearce, NP and VAE baselines),
    cli/ball.py;
  * --data_parallel on the three trainers and serve: one process per
    rank, each launching the kernels on its share of the batch or of the
    fit's rows, parallel/.
Public functions keep the JAX layouts: images are NHWC and GP shapes
follow svgpvae_tpu/gp/svgp.py.
"""

__version__ = "0.1.0"
