"""Serving layer of the port: the slab-layout engine, its KV pool and the
host-side modules it runs on (requests, workloads, metrics, policies,
telemetry).  The gateway, the steppable reactor and the chaos harness
are not ported yet."""
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.faults import SessionFault  # noqa: F401
from repro_torch.serving.kvcache import KVCachePool, KVExhausted  # noqa: F401
from repro_torch.serving.metrics import ServingReport, SLOThresholds  # noqa: F401
from repro_torch.serving.policies import POLICIES, PolicySpec  # noqa: F401
from repro_torch.serving.reactor import TokenEvent  # noqa: F401
from repro_torch.serving.workload import make_workload  # noqa: F401
