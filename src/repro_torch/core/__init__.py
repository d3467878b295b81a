"""The port's compiler core: the e-graph rewriting engine, extraction,
Auto Vectorize, Auto Distribution, Auto Schedule, buffer planning and a
PyTorch codegen, all reading one :class:`hardware.Hardware` record."""
