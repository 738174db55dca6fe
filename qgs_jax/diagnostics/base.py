"""
Diagnostics base classes
========================

Post-processing of model trajectories into physical fields and scalar
series (ref ``/root/reference/qgs/diagnostics/base.py:42-720``).

The central operation — reconstructing a field from spectral coefficients —
is a single contraction ``field[t] = sum_i coeff[i, t] * mode_i(x, y)``,
batched over all time records; it runs as a host matmul, with the mode
grids precomputed once per diagnostic.

Protocol: ``diag(time, data)`` or ``diag.set_data(time, data)`` followed by
``diag.diagnostic``; ``data`` has shape (ndim, n_records) (the integrators'
``get_trajectories`` output for one trajectory).
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod

import numpy as np

from qgs_jax.diagnostics.util import create_grid_basis


class Diagnostic(ABC):
    """Base class: holds the model parameters, the trajectory data and a
    cache of the computed diagnostic."""

    _default_points = 100

    def __init__(self, model_params, dimensional=True):
        self._model_params = model_params
        self.dimensional = dimensional
        self._time = None
        self._data = None
        self._diagnostic_data = None
        self._diagnostic_data_dimensional = False
        self._plot_title = ""
        self._plot_units = ""
        self._default_plot_kwargs = {}

    # -- data protocol -----------------------------------------------------

    def set_data(self, time, data):
        """Provide a trajectory: time (n_records,), data (ndim, n_records)."""
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        self._time = np.atleast_1d(np.asarray(time))
        self._data = data
        self._diagnostic_data = None

    def __call__(self, time, data):
        self.set_data(time, data)
        return self.diagnostic

    def set_params(self, model_params, kwargs=None):
        """Attach the diagnostic to a (new) model-parameters object,
        invalidating cached results; ``kwargs`` (same keywords as the
        constructor) reconfigure the instance
        (ref ``qgs/diagnostics/base.py:108-127``)."""
        if kwargs is not None:
            self.__init__(model_params, **kwargs)
        else:
            self._model_params = model_params
        self._diagnostic_data = None

    @property
    def diagnostic(self):
        """The computed diagnostic (cached)."""
        if self._data is None:
            warnings.warn("no data provided — call set_data first")
            return None
        if (self._diagnostic_data is None
                or self._diagnostic_data_dimensional != self.dimensional):
            self._get_diagnostic(self.dimensional)
        return self._diagnostic_data

    @abstractmethod
    def _get_diagnostic(self, dimensional):
        """Compute and store the diagnostic."""

    @property
    def time(self):
        if self._time is None:
            return None
        if self.dimensional:
            return self._time * self._model_params.dimensional_time
        return self._time

    @property
    def _offset(self):
        return 1 if self._model_params.dynamic_T else 0

    def _reconstruct(self, coeffs, grid_basis):
        """field[t, ...] = sum_i coeffs[i, t] * grid_basis[i, ...]."""
        nt = coeffs.shape[-1]
        gb = grid_basis.reshape(grid_basis.shape[0], -1)
        out = coeffs.T @ gb
        return out.reshape((nt,) + grid_basis.shape[1:])

    @property
    def plot_title(self):
        return self._plot_title

    @property
    def plot_units(self):
        return self._plot_units


class FieldDiagnostic(Diagnostic):
    """Base class for 2-D gridded field diagnostics, with plotting, movie
    and interactive-animation support."""

    def __init__(self, model_params, dimensional=True):
        Diagnostic.__init__(self, model_params, dimensional)
        self._X = None
        self._Y = None
        self._grid_basis = None
        self._orography = None
        self._color_bar_format = True

    def _compute_grid(self, delta_x=None, delta_y=None):
        n = float(self._model_params.scale_params.n)
        Lx, Ly = 2 * np.pi / n, np.pi
        if delta_x is None:
            n_x = self._default_points
        else:
            n_x = int(np.ceil(Lx / delta_x) + 1)
        if delta_y is None:
            n_y = self._default_points
        else:
            n_y = int(np.ceil(Ly / delta_y) + 1)
        x = np.linspace(0., Lx, n_x)
        y = np.linspace(0., Ly, n_y)
        self._X, self._Y = np.meshgrid(x, y)

    def _configure_grid_basis(self, basis, delta_x=None, delta_y=None):
        self._compute_grid(delta_x, delta_y)
        self._grid_basis = create_grid_basis(basis, self._X, self._Y)

    @property
    def grid(self):
        return self._X, self._Y

    @property
    def grid_shape(self):
        """Shape of the grid covering the model's domain
        (ref ``qgs/diagnostics/base.py:243-247``)."""
        if self._Y is not None:
            return self._Y.shape
        return None

    def __len__(self):
        d = self.diagnostic
        return 0 if d is None else d.shape[0]

    def plot_grid_point(self, i, j, ax=None, figsize=(16, 9), plot_kwargs=None):
        """Plot the time series of the field at grid point (i = x-index,
        j = y-index) (ref ``qgs/diagnostics/base.py:363-410``)."""
        import matplotlib.pyplot as plt

        field = self.diagnostic
        if field is None:
            warnings.warn("No diagnostic data available. Showing nothing.")
            return None
        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)
        t = self.time if self.time is not None else np.arange(field.shape[0])
        ax.plot(t, field[:, j, i], **(plot_kwargs or {}))
        ax.set_title(self._plot_title + f" at grid point ({i}, {j})"
                     + self._plot_units, pad=20)
        unit = self._model_params.time_unit if self.dimensional else "timeunits"
        ax.set_xlabel(f"time ({unit})")
        return ax

    # -- plotting ----------------------------------------------------------

    def plot(self, time_index=0, style="image", ax=None, figsize=(16, 9),
             contour_labels=True, color_bar=True, show_time=True,
             plot_kwargs=None, oro_kwargs=None):
        """Plot the field at a given time index.

        ``style``: 'image' (pcolormesh) or 'contour'."""
        import matplotlib.pyplot as plt

        field = self.diagnostic
        if field is None:
            return None
        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)

        pk = dict(self._default_plot_kwargs)
        if plot_kwargs:
            pk.update(plot_kwargs)

        if style == "contour":
            im = ax.contour(self._X, self._Y, field[time_index], **pk)
            if contour_labels:
                ax.clabel(im, fontsize=10)
        else:
            im = ax.pcolormesh(self._X, self._Y, field[time_index],
                               shading='gouraud', **pk)
            if color_bar:
                ax.figure.colorbar(im, ax=ax)

        if self._orography is not None and oro_kwargs is not False:
            ok = {'levels': 6, 'colors': 'k', 'linewidths': 0.8}
            if isinstance(oro_kwargs, dict):
                ok.update(oro_kwargs)
            ax.contour(self._X, self._Y, self._orography, **ok)

        title = self._plot_title
        if show_time and self.time is not None:
            t = self.time[time_index]
            unit = self._model_params.time_unit if self.dimensional else "timeunits"
            title += f" at {t:.2f} {unit}"
        ax.set_title(title + self._plot_units, pad=20)
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")
        return ax

    def movie(self, output='html', filename='', writer='ffmpeg', fps=15,
              figsize=(16, 9), plot_kwargs=None, anim_kwargs=None):
        """Render the field evolution as a matplotlib animation.

        ``output``: 'animate' (return the FuncAnimation), 'html'
        (HTML5 video string) or 'save' (write to ``filename``)."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        field = self.diagnostic
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(1, 1, 1)
        vmin, vmax = np.nanmin(field), np.nanmax(field)
        pk = dict(self._default_plot_kwargs)
        pk.update({'vmin': vmin, 'vmax': vmax})
        if plot_kwargs:
            pk.update(plot_kwargs)

        im = ax.pcolormesh(self._X, self._Y, field[0], shading='gouraud', **pk)
        fig.colorbar(im, ax=ax)
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")

        def update(frame):
            im.set_array(field[frame].ravel())
            t = self.time[frame] if self.time is not None else frame
            ax.set_title(self._plot_title + f" at {t:.2f}", pad=20)
            return (im,)

        ak = anim_kwargs or {}
        anim = FuncAnimation(fig, update, frames=field.shape[0], blit=False, **ak)
        if output == 'animate':
            return anim
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
            from IPython.display import display
        except ImportError:
            return self.movie(output='html', **kwargs)

        field = self.diagnostic

        def show(frame):
            self.plot(time_index=frame)

        slider = widgets.IntSlider(min=0, max=field.shape[0] - 1, step=1, value=0)
        return widgets.interactive(show, frame=slider)


class ProfileDiagnostic(Diagnostic):
    """Base class for 1-D profile diagnostics (e.g. zonally averaged)."""

    def __init__(self, model_params, dimensional=True):
        Diagnostic.__init__(self, model_params, dimensional)
        self._points = None
        self._axis_label = ""

    def plot(self, time_index=0, ax=None, figsize=(10, 6), plot_kwargs=None):
        import matplotlib.pyplot as plt

        prof = self.diagnostic
        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)
        ax.plot(self._points, prof[time_index], **(plot_kwargs or {}))
        ax.set_title(self._plot_title + self._plot_units)
        ax.set_xlabel(self._axis_label)
        return ax

    def __len__(self):
        d = self.diagnostic
        return 0 if d is None else d.shape[0]

    def movie(self, output='html', filename='', writer='ffmpeg', fps=15,
              figsize=(10, 6), plot_kwargs=None, anim_kwargs=None):
        """Animate the profile over time
        (ref ``qgs/diagnostics/base.py:782-850``)."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        prof = self.diagnostic
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(1, 1, 1)
        line, = ax.plot(self._points, prof[0], **(plot_kwargs or {}))
        ax.set_ylim(float(np.nanmin(prof)), float(np.nanmax(prof)))
        ax.set_title(self._plot_title + self._plot_units)
        ax.set_xlabel(self._axis_label)

        def update(frame):
            line.set_ydata(prof[frame])
            return (line,)

        anim = FuncAnimation(fig, update, frames=prof.shape[0], blit=False,
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

        prof = self.diagnostic

        def show(frame):
            self.plot(time_index=frame)

        slider = widgets.IntSlider(min=0, max=prof.shape[0] - 1, step=1, value=0)
        return widgets.interactive(show, frame=slider)


class FieldPointDiagnostic(Diagnostic):
    """Scalar time series of a field value at a grid point."""

    def __init__(self, model_params, x, y, field_diagnostic, dimensional=True):
        Diagnostic.__init__(self, model_params, dimensional)
        self._field = field_diagnostic
        self._x, self._y = x, y

    def set_point_coordinates(self, x, y):
        """Move the probed point; invalidates the cached series
        (ref ``qgs/diagnostics/base.py:185-195``)."""
        self._x, self._y = x, y
        self._diagnostic_data = None

    @property
    def point_coordinates(self):
        """(x, y) coordinates of the probed point."""
        return self._x, self._y

    def _get_diagnostic(self, dimensional):
        self._field.dimensional = dimensional
        self._field.set_data(self._time, self._data)
        field = self._field.diagnostic
        X, Y = self._field.grid
        ix = np.abs(X[0, :] - self._x).argmin()
        iy = np.abs(Y[:, 0] - self._y).argmin()
        self._diagnostic_data = field[:, iy, ix]
        self._diagnostic_data_dimensional = dimensional
        return self._diagnostic_data
