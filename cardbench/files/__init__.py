"""The files a loop takes, one source a module: `files/<name>.py`, found by
the mix's "files", holds make(torch, conf, mix, seed, device), which makes
the PCM on the device from the seed, copies it to the host once and gives
back its files: `pcm` (the host PCM), `files` (an endless iterator of
(pcm, start, n)) and `per_pass` (the files of one pass over the PCM)."""
