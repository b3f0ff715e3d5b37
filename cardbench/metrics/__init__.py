"""The benchmark's metrics, one reader a file: `<name>.py` holds
read(record) -> value, or None where the run has nothing for it to read,
and COUNTERS, where it reads the program's counters: {name: ["module:
attribute.path", ...]}, each counter the sum of its attributes, read at
the window's start and close. Files whose names start with `_` hold what
readers share."""
