"""NN units of the port: forward/gradient pairs with a numpy oracle path
and a torch device path.

Importing this package imports every unit module, so the MatchingObject
fwd<->gd registry that StandardWorkflow's layer-type lookup reads is
fully populated.
"""

from znicz_tpu_torch.units import (activation, all2all,  # noqa: F401
                                   conv, cutter, deconv, dropout, gd,
                                   gd_conv, gd_deconv, gd_pooling, lm,
                                   lr_adjust, mean_disp_normalizer,
                                   nn_rollback, normalization, pooling,
                                   rbm, resizable_all2all,
                                   weights_zerofilling)
