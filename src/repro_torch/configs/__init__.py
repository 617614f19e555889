"""Model configurations the serving path installs."""

from .paper_models import PAPER_MODELS, make_paper_model, train_qos_regressor

__all__ = ["PAPER_MODELS", "make_paper_model", "train_qos_regressor"]
