"""Training of the port: AdamW (``optim``) and the train step
(``step``), the counterparts of ``repro.training``."""
