"""Models of the port (xDeepFM so far, ``models/recsys.py``)."""
