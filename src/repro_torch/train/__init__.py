"""Training and step functions of the port: the step factories
(``steps``), the loop (``trainer``), checkpoints (``checkpoint``) and
the elastic plan (``elastic``)."""
