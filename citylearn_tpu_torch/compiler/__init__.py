from citylearn_tpu_torch.compiler.schema import compile_schema  # noqa: F401
from citylearn_tpu_torch.compiler.spec import BuildingSpec, DistrictSpec  # noqa: F401
