"""Serving layer: async multi-tenant simulation service with
structure-keyed dynamic batching, the port of ``repro.serve`` (see
:mod:`repro_torch.serve.service` for the request-path overview and README
"Serving" for the architecture sketch).

Entry points:

* :class:`SimulationService` + :class:`ServeConfig` — the asyncio loop.
* :class:`SimRequest` / :class:`SimResponse` — the request/response shapes.
* ``python -m repro_torch.launch.serve_sim`` — TCP front end and demo.
"""

from .batcher import (  # noqa: F401
    Batch,
    DynamicBatcher,
    GroupKey,
    SimRequest,
    SimResponse,
    bucket_size,
    group_key_for,
)
from .metrics import Histogram, Metrics  # noqa: F401
from .queue import FairAdmissionQueue, QueueFull  # noqa: F401
from .service import (  # noqa: F401
    CircuitQuarantined,
    RequestTimeout,
    ServeConfig,
    ServiceOverloaded,
    ServiceStopped,
    SimulationService,
    WarmPool,
)
