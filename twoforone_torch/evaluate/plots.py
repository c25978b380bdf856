"""Plots of the evaluators: Ramachandran free energy, TICA maps, PWD
histograms, RMSD free-energy curves and contact-count maps (port of
``twoforone_tpu/evaluate/plots.py``).

matplotlib is imported inside each function, so it stays off the training
path; where it is not installed, a plot raises ImportError as the JAX
package's does.
"""

from __future__ import annotations

import math
import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_free_energy_2d(probs, file_name, n_bins=61, title="", save_plot=True):
    """Ramachandran free-energy contour plot."""
    plt = _plt()
    from matplotlib import cm

    from twoforone_torch.evaluate.metrics import K_BT_IN_KCAL_PER_MOL

    plt.rcParams.update({"font.size": 15})
    _, ax = plt.subplots()
    with np.errstate(divide="ignore"):
        ys = -np.log(np.asarray(probs, dtype=np.float64)) * K_BT_IN_KCAL_PER_MOL
    ys = ys - np.nanmin(ys[np.isfinite(ys)])
    bin_edges = np.linspace(-np.pi, np.pi, n_bins)
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    cc = ax.contourf(
        bin_centers, bin_centers, ys.T, vmax=5,
        levels=np.linspace(0.0, 5.5, 12), extend="max", antialiased=False,
        cmap="magma",
    )
    cbar = plt.colorbar(cc, ax=ax)
    cbar.set_label("Free energy / kcal$\\cdot$mol$^{-1}$")
    line_colors = []
    for i, j in enumerate(np.linspace(0, 1, 12)):
        if i % 2 == 0 and i < 9:
            line_colors.append(cm.binary(j))
        else:
            line_colors.append((0.498, 0.498, 0.498, 0.0))
    ax.contour(cc, colors=line_colors, linewidths=1.5, antialiased=True)
    ax.set_title(title)
    plt.xticks([-math.pi, 0, math.pi], ["-π", "0", "π"])
    plt.yticks([-math.pi, 0, math.pi], ["-π", "0", "π"])
    plt.xlabel("ϕ")
    plt.ylabel("ψ")
    if save_plot:
        plt.savefig(file_name)
    plt.close()


def plot_tic_map(probs, bin_mids_x, bin_mids_y, bin_x_folded, bin_y_folded,
                 title, file_name, path=None, cmap="OrRd", gradient=True,
                 steps=3, linewidth=2, save_plot=True):
    """TIC0-vs-TIC1 log-density map with the folded-state marker and an
    optional trajectory path."""
    plt = _plt()
    from matplotlib.colorbar import ColorbarBase
    from matplotlib.colors import LogNorm, Normalize

    fig, (ax1, ax2) = plt.subplots(1, 2, dpi=150, gridspec_kw={"width_ratios": [24, 1]})
    ax1.imshow(probs.T, norm=LogNorm(vmax=10, vmin=1e-4), origin="lower", zorder=1)
    ax1.set_xticks(range(len(bin_mids_x))[5::15],
                   [f"{num:.02f}" for num in bin_mids_x[5::15]])
    ax1.set_yticks(range(len(bin_mids_y))[5::15],
                   [f"{num:.02f}" for num in bin_mids_y[5::15]])
    if path is not None:
        edges_x = bin_mids_x[0], bin_mids_x[-1]
        edges_y = bin_mids_y[0], bin_mids_y[-1]
        xfactor = (ax1.get_xlim()[1] - ax1.get_xlim()[0]) / (edges_x[1] - edges_x[0])
        yfactor = (ax1.get_ylim()[1] - ax1.get_ylim()[0]) / (edges_y[1] - edges_y[0])
        plotx = (path[:, 0] - edges_x[0]) * xfactor
        ploty = (path[:, 1] - edges_y[0]) * yfactor
        if gradient:
            from matplotlib.collections import LineCollection
            import matplotlib.path as mpath

            mp = mpath.Path(np.column_stack([plotx, ploty]))
            verts = mp.interpolated(steps=steps).vertices
            px, py = verts[:, 0], verts[:, 1]
            segments = np.array([px[:-1], py[:-1], px[1:], py[1:]]).T.reshape(-1, 2, 2)
            lc = LineCollection(segments, cmap=cmap, norm=plt.Normalize(0, len(px)))
            lc.set_array(range(len(px)))
            lc.set_linewidth(linewidth)
            ax1.add_collection(lc)
        else:
            ax1.plot(plotx, ploty, color="orange", linewidth=linewidth, zorder=2)
    ax1.scatter(bin_x_folded, bin_y_folded, marker="X", c="firebrick", s=200,
                linewidth=0, zorder=3)
    ax1.set_xlabel("TIC 0", labelpad=10, size=12)
    ax1.set_ylabel("TIC 1", labelpad=10, size=12)
    ax1.set_title(title, fontsize=14, pad=10)
    ax1.axis("off")

    norm = Normalize(vmin=0, vmax=10)
    bounds = [0.0, 2.0, 4.0, 6.0, 8.0, 10.0]
    cb1 = ColorbarBase(
        ax2, cmap=plt.cm.viridis_r, norm=norm, boundaries=[0] + bounds + [15],
        extend="max", extendfrac=0.1, ticks=bounds, spacing="uniform",
        orientation="vertical",
    )
    cb1.set_label("Free energy / $k_BT$", labelpad=-1)
    plt.tight_layout()
    if save_plot:
        plt.savefig(file_name)
    return fig


def plot_pwd_histograms(gt_pwd_triu, pwd_sampled, file_name, save_plot=True):
    """Ala2 per-pair PWD histogram grid, ground truth vs sampled."""
    plt = _plt()
    import matplotlib.patches as mpatches

    assert gt_pwd_triu.shape[-1] == pwd_sampled.shape[-1], "Shape mismatch"
    c1, c2 = "tab:green", "tab:orange"
    patches = [
        mpatches.Patch(color=c1, label="Ground truth"),
        mpatches.Patch(color=c2, label="Sampled"),
    ]
    fig, axes = plt.subplots(nrows=2, ncols=5, figsize=(8, 4))
    axes = axes.flatten()
    for i in range(gt_pwd_triu.shape[-1]):
        axes[i].hist(gt_pwd_triu[:, i], bins=20, density=True, color=c1,
                     alpha=0.5, edgecolor=c1)
        axes[i].hist(pwd_sampled[:, i], bins=20, density=True, color=c2,
                     alpha=0.5, edgecolor=c2)
        axes[i].set_title(f"{i + 1}", fontsize=14)
    ax0 = fig.add_subplot(111, frameon=False)
    ax0.set_xlabel("Pairwise distance (Å)", labelpad=20, fontsize=12)
    ax0.set_ylabel("Density", labelpad=20, fontsize=12)
    ax0.set_xticks([])
    ax0.set_yticks([])
    ax0.legend(handles=patches, loc="lower center", ncol=2, borderaxespad=-6,
               fontsize=12)
    plt.tight_layout()
    if save_plot:
        plt.savefig(file_name)
    plt.close(fig)


def plot_rmsd_free_energy(plot_dict, mol_name, plots_folder, save=True,
                          colors=None, linestyles=None, legend_bool=True,
                          font_size=10, linewidth=None):
    """RMSD-to-folded free-energy curves, one per method of ``plot_dict``."""
    plt = _plt()
    for i, (method, md_) in enumerate(plot_dict.items()):
        plt.plot(
            md_["bin_mids"], md_["energies"], label=method,
            c=None if colors is None else colors[i],
            linestyle=None if linestyles is None else linestyles[i],
            linewidth=linewidth,
        )
    plt.tick_params(axis="both", labelsize=font_size)
    plt.xlabel(r"$C_{\alpha}$ RMSD to folded (Å)")
    plt.ylabel(r"Free energy / $k_BT$")
    if legend_bool:
        plt.legend(prop={"size": font_size})
    if save:
        plt.savefig(os.path.join(plots_folder, f"RMSD_{mol_name}_free_energy.png"))
    plt.close()


def plot_contact_normcount(norm_sum, mol_name, method, plots_folder,
                           save=True, take_log=False, vmin_log=None):
    """Normalized contact-count map; returns the least finite value plotted
    (of the log map or the linear one)."""
    plt = _plt()
    plt.figure(figsize=(6, 6))
    if take_log:
        with np.errstate(divide="ignore"):
            plotted = np.log(norm_sum)
        plt.imshow(plotted, cmap="viridis_r", vmin=vmin_log)
        label = "Log of normalized contact count"
    else:
        plotted = norm_sum
        plt.imshow(plotted, cmap="viridis_r", vmin=0, vmax=1)
        label = "Normalized contact count"
    plt.xticks(np.arange(0, len(norm_sum), 5))
    plt.yticks(np.arange(0, len(norm_sum), 5))
    cb = plt.colorbar(format=lambda x, _: f"{x:.1f}", shrink=0.788)
    cb.set_label(label, fontsize=12)
    plt.title(f"{method}", fontsize=12, y=1.02)
    plt.tight_layout()
    if save:
        plt.savefig(os.path.join(plots_folder, f"contact_normcount_{mol_name}_{method}.png"))
    plt.close()
    return float(np.min(plotted[np.isfinite(plotted)]))
