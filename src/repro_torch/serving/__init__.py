"""The port's serving surface: the engines, the request API, the
continuous-batching scheduler and its overload policy, the model backend,
the network front door (``FrontDoorServer``) and the fleet layer
(``FleetRouter``: replica front doors behind one wire-compatible router)."""

from repro_torch.serving.api import (MAX_STOP_IDS, GenerationParams,
                                     RequestCancelled, RequestHandle,
                                     RequestRejected, RequestSpec,
                                     RequestStatus)
from repro_torch.serving.backend import (DecoderOnlyBackend, Seq2SeqBackend,
                                         make_backend)
from repro_torch.serving.engine import (EngineConfig, Prediction,
                                        ReactionEngine, StreamingEngine)
from repro_torch.serving.scheduler import (ContinuousScheduler,
                                           OverloadPolicy, ScheduledRequest,
                                           SlotResult)
from repro_torch.serving.fleet import FleetConfig, FleetRouter
from repro_torch.serving.server import FrontDoorServer, ServerConfig

__all__ = [
    "ReactionEngine", "StreamingEngine", "EngineConfig", "Prediction",
    "ContinuousScheduler", "ScheduledRequest", "SlotResult",
    "OverloadPolicy",
    "Seq2SeqBackend", "DecoderOnlyBackend", "make_backend",
    "GenerationParams", "RequestSpec", "RequestHandle", "RequestStatus",
    "RequestCancelled", "RequestRejected", "MAX_STOP_IDS",
    "FrontDoorServer", "ServerConfig",
    "FleetRouter", "FleetConfig",
]
