"""
Scalar variable diagnostics
===========================

Time series of the model's spectral coefficients (with per-component
dimensionalization) and derived scalar series such as geopotential height
differences between domain points (ref ``qgs/diagnostics/variables.py:29-751``).
"""

from __future__ import annotations

import numpy as np

from qgs_jax.diagnostics.base import Diagnostic


class VariablesDiagnostic(Diagnostic):
    """Time series of selected model variables."""

    def __init__(self, variable_list, model_params, dimensional=True):
        Diagnostic.__init__(self, model_params, dimensional)
        self._variable_list = list(variable_list)
        self._plot_title = 'Model variables'
        self._variable_labels = [model_params.latex_var_string[v]
                                 if v < len(model_params.latex_var_string) else str(v)
                                 for v in self._variable_list]

    def _scaling(self, var):
        """Dimensionalization factor for one variable index."""
        mp = self._model_params
        vr = mp.variables_range
        if var < vr[0]:
            return float(mp.streamfunction_scaling)
        if var < vr[1]:
            return float(mp.temperature_scaling) * 2
        if mp.oceanic_basis is not None:
            if var < vr[2]:
                return float(mp.streamfunction_scaling)
            return float(mp.temperature_scaling)
        return float(mp.temperature_scaling)

    def _get_diagnostic(self, dimensional):
        rows = []
        for v in self._variable_list:
            series = self._data[v, :].astype(np.float64)
            if dimensional:
                series = series * self._scaling(v)
            rows.append(series)
        self._diagnostic_data = np.array(rows)
        self._diagnostic_data_dimensional = dimensional
        return self._diagnostic_data

    def plot(self, ax=None, figsize=(10, 6), plot_kwargs=None):
        import matplotlib.pyplot as plt

        series = self.diagnostic
        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)
        for lab, row in zip(self._variable_labels, series):
            ax.plot(self.time, row, label=f"${lab}$", **(plot_kwargs or {}))
        ax.legend()
        ax.set_xlabel("time")
        ax.set_title(self._plot_title)
        return ax

    def __len__(self):
        d = self.diagnostic
        return 0 if d is None else d.shape[-1]

    def movie(self, output='html', filename='', writer='ffmpeg', fps=15,
              figsize=(10, 6), plot_kwargs=None, anim_kwargs=None):
        """Animate the time series with a moving dot marking the current
        value of each variable (ref ``qgs/diagnostics/variables.py``,
        ``movie``/``animate`` of the scalar diagnostics)."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        series = self.diagnostic
        fig = plt.figure(figsize=figsize)
        ax = self.plot(ax=fig.add_subplot(1, 1, 1), plot_kwargs=plot_kwargs)
        t = self.time
        dots = [ax.plot([t[0]], [row[0]], 'ro')[0] for row in series]

        def update(frame):
            for dot, row in zip(dots, series):
                dot.set_data([t[frame]], [row[frame]])
            return dots

        anim = FuncAnimation(fig, update, frames=series.shape[-1], blit=False,
                             **(anim_kwargs or {}))
        if output == 'html':
            html = anim.to_html5_video()
            plt.close(fig)
            return html
        if output == 'save':
            anim.save(filename, writer=writer, fps=fps)
            plt.close(fig)
            return filename
        return anim

    def animate(self, output='animate', **kwargs):
        """Interactive animation (ipywidgets if available, else the movie)."""
        try:
            import ipywidgets as widgets
        except ImportError:
            return self.movie(output='html', **kwargs)

        series = self.diagnostic

        def show(frame):
            import matplotlib.pyplot as plt
            ax = self.plot()
            for row in series:
                ax.plot([self.time[frame]], [row[frame]], 'ro')
            plt.show()

        slider = widgets.IntSlider(min=0, max=series.shape[-1] - 1, step=1,
                                   value=0)
        return widgets.interactive(show, frame=slider)


class GeopotentialHeightDifferenceDiagnostic(VariablesDiagnostic):
    """Geopotential height difference between couples of domain points,
    from the barotropic streamfunction field."""

    def __init__(self, points_list, model_params, dimensional=True):
        VariablesDiagnostic.__init__(self, list(range(len(points_list))),
                                     model_params, dimensional)
        self._plot_title = 'Geopotential height difference between points'
        self._plot_units = ' (in meters)'
        self.set_points(points_list)

    def set_points(self, points_list):
        """Set the list of ((x1, y1), (x2, y2)) point couples."""
        o = self._offset
        basis = self._model_params.atmospheric_basis
        funcs = basis.num_functions()[o:]
        self._point1 = [p[0] for p in points_list]
        self._point2 = [p[1] for p in points_list]
        self._func_points1 = np.array([[f(*p) for f in funcs] for p in self._point1])
        self._func_points2 = np.array([[f(*p) for f in funcs] for p in self._point2])
        self._variable_labels = [
            rf"({p1[0]:.2f},{p1[1]:.2f})-({p2[0]:.2f},{p2[1]:.2f})"
            for p1, p2 in zip(self._point1, self._point2)]

    def _get_diagnostic(self, dimensional):
        vr = self._model_params.variables_range
        psi = self._data[:vr[0], :]
        v1 = self._func_points1 @ psi
        v2 = self._func_points2 @ psi
        out = v1 - v2
        if dimensional:
            out = out * (float(self._model_params.geopotential_scaling)
                         * float(self._model_params.streamfunction_scaling))
        self._diagnostic_data = out
        self._diagnostic_data_dimensional = dimensional
        return out
