"""Model configurations of the port (``configs/base.py`` holds the
registry)."""
from repro_torch.configs.base import all_archs, get  # noqa: F401
