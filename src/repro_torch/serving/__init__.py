from repro_torch.serving.engine import (  # noqa: F401
    EngineStats, Request, ServingEngine,
)
from repro_torch.serving.policies import (  # noqa: F401
    FairScheduler, PriorityScheduler,
)
from repro_torch.serving.prefix_cache import (  # noqa: F401
    CrossKVCache, HostSpillStore, PromptLookupDraft, RadixPrefixCache,
)
from repro_torch.serving.sampler import SamplerConfig  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    Admission, FCFSScheduler, Scheduler,
)
