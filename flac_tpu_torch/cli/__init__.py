"""Command-line tools of the port: the `metaflac` equivalent
(src/metaflac/), run as `python -m flac_tpu_torch.cli.metaflac`. The `flac`
tool and the others wait for ROADMAP item 11b."""
