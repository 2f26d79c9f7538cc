from citylearn_tpu_torch.end_use_load_profiles.neighborhood import Neighborhood  # noqa: F401
