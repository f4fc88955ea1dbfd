from tod_tpu_torch.train.matcher import match_anchors  # noqa: F401
from tod_tpu_torch.train.losses import yolact_loss  # noqa: F401
from tod_tpu_torch.train.synthetic_data import SyntheticDetectionData  # noqa: F401
from tod_tpu_torch.train.dataset import DiskDetectionData, export_dataset  # noqa: F401
from tod_tpu_torch.train.augment import Augmented, apply_augment, draw_augment  # noqa: F401
from tod_tpu_torch.train.domainrand import DomainRandomizedData  # noqa: F401
from tod_tpu_torch.train.pool import ScenePool  # noqa: F401
from tod_tpu_torch.train.trainer import TrainState, Trainer, make_train_step  # noqa: F401
