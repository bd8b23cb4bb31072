"""Click-through rate, lifetime and over the last ``max_num_updates`` updates."""

from portbench.reference import formulas as f
from portbench.reference.members import windowed_ratio

reference = windowed_ratio(f.ctr)
