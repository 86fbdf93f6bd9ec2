from .fault import Heartbeat, StragglerWatchdog, elastic_mesh_shape, retry, retry_jitter

__all__ = ["Heartbeat", "StragglerWatchdog", "elastic_mesh_shape", "retry", "retry_jitter"]
