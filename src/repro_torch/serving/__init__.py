"""The port's serving surface: the engines, the request API, the
continuous-batching scheduler and the model backend."""

from repro_torch.serving.api import (MAX_STOP_IDS, GenerationParams,
                                     RequestCancelled, RequestHandle,
                                     RequestRejected, RequestSpec,
                                     RequestStatus)
from repro_torch.serving.backend import Seq2SeqBackend, make_backend
from repro_torch.serving.engine import (EngineConfig, Prediction,
                                        ReactionEngine, StreamingEngine)
from repro_torch.serving.scheduler import (ContinuousScheduler,
                                           ScheduledRequest, SlotResult)

__all__ = [
    "ReactionEngine", "StreamingEngine", "EngineConfig", "Prediction",
    "ContinuousScheduler", "ScheduledRequest", "SlotResult",
    "Seq2SeqBackend", "make_backend",
    "GenerationParams", "RequestSpec", "RequestHandle", "RequestStatus",
    "RequestCancelled", "RequestRejected", "MAX_STOP_IDS",
]
