"""The port's SPRITES driver against the JAX CLI at the SPRITES record
config's flags on the Titsias bound through fused (the Titsias CUDA cell,
as the record runs, no GECO): the case of
tests/test_torch_titsias_cli_record.py's test that runs apart from the
Hensman one, so that the suite's workers take the two in parallel.
Tolerances as there.
"""

import pytest

from svgpvae_tpu_torch import data as tdata

from test_torch_titsias_cli_record import SPRITES_CHARS, check_record_case
from torch_threads import _torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def sprites_corpus():
    return tdata.generate_synthetic_sprites(
        n_train_chars=SPRITES_CHARS, n_test_chars=2, n_frames_train=50,
        seed=0)


@pytest.mark.parametrize("case", ["titsias-fused"])
def test_sprites_record_config_matches_jax_cli(tmp_path, sprites_corpus,
                                               case, monkeypatch):
    check_record_case(tmp_path, sprites_corpus, case, monkeypatch)
