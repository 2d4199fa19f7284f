"""GP surrogate: configuration, core math, training and prediction."""

from vbmc_tpu_torch.gp.config import GPConfig
from vbmc_tpu_torch.gp.gp import GP, HypPrior
from vbmc_tpu_torch.gp.core import (
    gram_matrix,
    build_posterior,
    neg_log_marginal_likelihood,
    hyperprior_logpdf,
)
from vbmc_tpu_torch.gp.predict import gp_predict, gp_predict_full
from vbmc_tpu_torch.gp.fit import train_gp, TrainOptions
from vbmc_tpu_torch.gp.means import fix_center_from_data

__all__ = [
    "fix_center_from_data",
    "GPConfig",
    "GP",
    "HypPrior",
    "gram_matrix",
    "build_posterior",
    "neg_log_marginal_likelihood",
    "hyperprior_logpdf",
    "gp_predict",
    "gp_predict_full",
    "train_gp",
    "TrainOptions",
]
