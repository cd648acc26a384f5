"""Entry points and input builders: the trainer (``train``) and the batch
of every family (``specs``)."""
