"""Gold engine: reference-faithful host implementation of classify.

This is the correctness oracle: its output is bit-compared against the
reference binary (tests/golden/) and then used to validate the device
engine. Structured after the reference call stack (SURVEY.md §3.4):
islands -> fast/slow FM seeding -> map_seed/LV -> chaining -> 9-mer SDP
rescoring -> filtering -> primary detection.
"""
from .classify import ClassifyEngine, Options  # noqa: F401
