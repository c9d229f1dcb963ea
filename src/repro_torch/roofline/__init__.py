"""Roofline terms for the port on one NVIDIA H100 (port of the parts of
``repro.roofline`` that serving reads)."""
