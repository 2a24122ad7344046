from .config import config, global_config, using_config
from .link import Chain, ChainList, Link, Parameter
from .optimizer import (SGD, AdaDelta, AdaGrad, Adam, AdamW, GradientClipping,
                        GradientHardClipping, GradientMethod, GradientScaling,
                        Lasso, MomentumSGD, NesterovAG, Optimizer, RMSprop,
                        WeightDecay)
from .reporter import (DictSummary, Reporter, Summary, get_current_reporter,
                       report, report_scope)

__all__ = ["Parameter", "Link", "Chain", "ChainList", "Optimizer", "GradientMethod",
           "SGD", "MomentumSGD", "NesterovAG", "Adam", "AdamW", "RMSprop",
           "AdaGrad", "AdaDelta", "WeightDecay", "Lasso", "GradientClipping",
           "GradientHardClipping", "GradientScaling", "Reporter", "report",
           "report_scope", "get_current_reporter", "Summary", "DictSummary",
           "config", "global_config", "using_config"]
