from citylearn_tpu_torch.core.params import initial_state, pack  # noqa: F401
from citylearn_tpu_torch.core.step import district_step  # noqa: F401
