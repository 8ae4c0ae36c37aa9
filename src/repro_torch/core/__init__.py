"""The port of ``repro.core``: §6.1 fault tolerance (:mod:`repro_torch.core.ft`)."""
