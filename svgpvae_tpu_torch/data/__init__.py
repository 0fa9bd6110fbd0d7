from svgpvae_tpu_torch.data.ball import (  # noqa: F401
    VideoBatchFn,
    make_circles,
    make_path_batch,
    make_squares,
    make_test_batches,
    make_video_batch,
    make_video_batch_fn,
)
from svgpvae_tpu_torch.data.mnist import (  # noqa: F401
    derive_base_images_from_eval,
    generate_init_inducing_points,
    generate_rotated_mnist,
    load_keras_mnist_npz,
    load_rotated_mnist,
    pca_embeddings,
    pca_embeddings_gram,
    synthetic_digit_base_images,
)
from svgpvae_tpu_torch.data.sprites import (  # noqa: F401
    N_ACTIONS,
    generate_synthetic_sprites,
    has_raw_sprites_npys,
    load_raw_sprites_npys,
    load_sprites,
    preprocess_sprites,
    save_sprites_shards,
    sprites_batch_iterator,
    sprites_pca_init,
)
