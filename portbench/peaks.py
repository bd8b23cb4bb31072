"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense, at the full 700 W power limit; a card set below it runs slower
under load, so each run prints its ``power.limit`` beside the result)."""

HBM_BYTES_PER_S = 3.35e12
