"""Step functions of the port (the serving half of
``repro/train/steps.py`` so far)."""
