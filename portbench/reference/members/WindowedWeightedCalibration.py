"""Calibration (probabilities summed over positives), lifetime and windowed."""

from portbench.reference import formulas as f
from portbench.reference.members import windowed_ratio

reference = windowed_ratio(f.calibration)
