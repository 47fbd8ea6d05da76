"""The share, in %, of the traced window's pixels whose history was taken
(history length past 1 after the temporal step): the counter
`reprojected_px` (summed on the device) over `pixels`, over every frame
of the window.  Higher: more of each frame starts from its history.
Moves frame_ms (through the temporal step's work, not its time)."""

from benchmark.spans import reprojected_pct


def read(trace):
    return reprojected_pct()
