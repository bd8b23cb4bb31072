"""Normalized entropy: mean cross entropy over the base rate's entropy."""

from portbench.reference import formulas as f
from portbench.reference.members import ratio

reference = ratio(f.normalized_entropy, [1])
