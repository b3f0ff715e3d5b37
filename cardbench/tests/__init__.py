"""CPU tests of the benchmark (cuda-marked ones run on the card)."""
