"""Click-through rate: positives over samples."""

from portbench.reference import formulas as f
from portbench.reference.members import ratio

reference = ratio(f.ctr, [])
