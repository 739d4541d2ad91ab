"""SSL method modules. Importing this package registers the methods."""

from cvssl_tpu_torch.train.methods.base import (  # noqa: F401
    Method, get_method, register_method)
from cvssl_tpu_torch.train.methods import supervised  # noqa: F401
from cvssl_tpu_torch.train.methods import mean_teacher  # noqa: F401
from cvssl_tpu_torch.train.methods import uamt  # noqa: F401
from cvssl_tpu_torch.train.methods import ict  # noqa: F401
from cvssl_tpu_torch.train.methods import co_training  # noqa: F401
from cvssl_tpu_torch.train.methods import cps  # noqa: F401
from cvssl_tpu_torch.train.methods import cct  # noqa: F401
from cvssl_tpu_torch.train.methods import urpc  # noqa: F401
from cvssl_tpu_torch.train.methods import fixmatch  # noqa: F401
from cvssl_tpu_torch.train.methods import adversarial  # noqa: F401
from cvssl_tpu_torch.train.methods import exam  # noqa: F401
from cvssl_tpu_torch.train.methods import cross_teaching  # noqa: F401
from cvssl_tpu_torch.train.methods import cnn_meet_vit  # noqa: F401
from cvssl_tpu_torch.train.methods import tripleview  # noqa: F401
from cvssl_tpu_torch.train.methods import adversarial_consistency  # noqa: F401
from cvssl_tpu_torch.train.methods import contrastive  # noqa: F401
from cvssl_tpu_torch.train.methods import contrastive_consistency  # noqa: F401
