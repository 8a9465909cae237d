"""Neural-field volumes (port of `ovr_tpu.neural`): a hash-grid MLP field
the renderer samples in place of a dense grid, its fitting to a grid,
the inverse-rendering train step and the bakes to a dense lattice."""

from ovr_tpu_torch.neural.field import (NeuralFieldVolume, field_sample,
                                        init_field, sample_any_volume)
from ovr_tpu_torch.neural.hashgrid import (HashGridConfig, encode,
                                           init_hashgrid)
from ovr_tpu_torch.neural.losses import l1, l2, relative_l2
from ovr_tpu_torch.neural.train import (bake_grid, fit_to_grid,
                                        make_image_train_step)

__all__ = ["NeuralFieldVolume", "field_sample", "init_field",
           "sample_any_volume", "HashGridConfig", "encode", "init_hashgrid",
           "l1", "l2", "relative_l2", "bake_grid", "fit_to_grid",
           "make_image_train_step"]
