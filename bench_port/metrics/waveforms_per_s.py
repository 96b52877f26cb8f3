"""waveforms_per_s: every waveform whose coords reached the host over
the window, over the window's seconds, host clock."""


def read(rec):
    w = rec.window
    return w["waveforms"] / w["seconds"] if "waveforms" in w else None
