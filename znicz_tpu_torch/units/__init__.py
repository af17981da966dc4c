"""NN units of the port: forward/gradient pairs with a numpy oracle path
and a torch device path.

Importing this package imports every unit module, so the MatchingObject
fwd<->gd registry that StandardWorkflow's layer-type lookup reads is
fully populated.
"""

from znicz_tpu_torch.units import (all2all, conv, deconv,  # noqa: F401
                                   dropout, gd, gd_conv, gd_deconv,
                                   gd_pooling, lm, mean_disp_normalizer,
                                   normalization, pooling)
