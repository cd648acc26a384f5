"""Clock2Q+ cache substrate of the port: the lane-batched policy engine
(``core.engine``), its replay drivers (``core.torch_engine``), trace
generation (``core.traces``) and the pure-Python Clock2Q+ oracle
(``core.policies.clock2qplus``)."""
