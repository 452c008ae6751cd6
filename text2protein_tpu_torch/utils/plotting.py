"""Sample-channel visualization (counterpart of
text2protein_tpu/utils/plotting.py)."""

from __future__ import annotations

import numpy as np


def show_all_channels(sample, path=None, nrows=1, ncols=8):
    """ImageGrid of per-channel maps for a batch of samples. `sample` is an
    iterable of (C, N, N) (or NHWC (N, N, C)) arrays or tensors. Needs
    matplotlib, which is imported here and nowhere else."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import ImageGrid

    fig = plt.figure(figsize=(10, 10))
    grid = ImageGrid(fig, 111, nrows_ncols=(nrows, ncols), axes_pad=0.1,
                     share_all=True)
    grid[0].get_yaxis().set_ticks([])
    grid[0].get_xaxis().set_ticks([])

    ax_idx = 0
    for s in sample:
        s = np.asarray(s.detach().cpu() if hasattr(s, "detach") else s)
        if s.ndim == 3 and s.shape[0] not in (5, 8) and s.shape[-1] in (5, 8):
            s = s.transpose(2, 0, 1)  # NHWC -> CNN
        for ch in range(min(ncols, s.shape[0])):
            grid[ax_idx].imshow(s[ch])
            ax_idx += 1

    if path:
        plt.savefig(path)
    plt.close(fig)
    return fig
