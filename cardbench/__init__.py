"""The benchmark of flac_tpu_torch on the card: BENCHMARK.json's cells,
run one at a time by run.py."""
