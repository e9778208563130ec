"""Model configurations of the port (``configs/base.py`` holds the
registry)."""
