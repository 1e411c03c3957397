from repro_torch.serving.engine import EngineConfig, Prediction, ReactionEngine

__all__ = ["EngineConfig", "Prediction", "ReactionEngine"]
