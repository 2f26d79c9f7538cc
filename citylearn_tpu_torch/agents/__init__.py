from citylearn_tpu_torch.agents.base import Agent, BaselineAgent  # noqa: F401
from citylearn_tpu_torch.agents.rbc import (  # noqa: F401
    RBC,
    BasicBatteryRBC,
    BasicElectricVehicleRBC_ReferenceController,
    BasicRBC,
    HourRBC,
    OptimizedRBC,
)
