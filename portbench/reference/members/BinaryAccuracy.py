"""Binary accuracy at the threshold 0.5."""

from portbench.reference import formulas as f
from portbench.reference.members import ratio

reference = ratio(f.accuracy, [])
