from repro_torch.serving.engine import (  # noqa: F401
    EngineStats, Request, ServingEngine,
)
from repro_torch.serving.sampler import SamplerConfig  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    Admission, FCFSScheduler, Scheduler,
)
