"""Training in the port: the LM trainer (``make_train_step``, the
fault-tolerant ``Trainer``) and the UM-backed ``UMTrainer`` over its offload
plan (the port of ``repro.train``)."""
from repro_torch.train.trainer import (  # noqa: F401
    Trainer,
    TrainerConfig,
    TrainState,
    load_state_,
    make_train_state,
    make_train_step,
)
from repro_torch.train.offload import (  # noqa: F401
    TRAIN_MODELS,
    TrainHints,
    TrainMemPlan,
    TrainModelSpec,
    capacity_for,
    device_demand_bytes,
    get_train_model,
    state_bytes,
)
from repro_torch.train.umtrain import UMTrainer  # noqa: F401
