"""AgentServe core: phase classification, the TPOT controller, the slot
grid, dual-queue admission and the plan-based scheduling core.  Host-only
code, copied from the JAX package with its imports rewritten."""
from repro_torch.core.phases import Phase, PhaseThresholds, classify  # noqa: F401
from repro_torch.core.scheduler import (  # noqa: F401
    ControlState, SchedulerConfig, TPOTScheduler)
from repro_torch.core.slots import SlotManager, SlotStats  # noqa: F401
from repro_torch.core.admission import AdmissionQueues, Job  # noqa: F401
from repro_torch.core.planner import (  # noqa: F401
    Admission, ColdOp, CyclePlan, CyclePlanner, CycleRecord, DecodePlan,
    EngineView, JobView, PlanJournal, PolicySpec, ReplayPlanner,
    ResumePlan, SessionView)
