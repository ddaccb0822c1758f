"""Deterministic, resumable host-side data streams (port of
``repro.data``)."""
from repro_torch.data.c4_mock import C4Mock
from repro_torch.data.synthetic import SyntheticLM

__all__ = ["C4Mock", "SyntheticLM"]
