"""Reporters: stream rows, AMBER NetCDF, HDF5, restart, progress.

The port's copy of ``blues_tpu.reporters.reporters``: the same files and
rows from torch state. A report reads what it needs with one ``.cpu()``
copy per array (replica 0's slice for trajectories), never per step.
Reimplements the reference's observability layer (blues/reporters.py +
blues/formats.py) at iteration granularity — the driver hands each reporter
the iteration stats and the collected MD / NCMC frames (the reference
attaches per-step reporters to OpenMM Simulation objects instead; frame
cadence is configured the same way via reportInterval / frame_indices).

Formats:
  * NetCDFReporter — AMBER NetCDF convention trajectory via
    scipy.io.netcdf_file, with the BLUES extension variables protocolWork
    (kT) and alchemicalLambda (reference: blues/formats.py:476-691
    NetCDF4Traj).
  * HDF5Reporter — mdtraj-HDF5-style layout via h5py, plus protocolWork /
    alchemicalLambda / JSON parameters (reference: blues/formats.py:87-473
    BLUESHDF5TrajectoryFile).
  * StateDataReporter — iter / step / PE / temperature / work / speed
    (ns/day) / progress / remaining-time rows through the logging stack at
    REPORT level (reference: blues/reporters.py:436-728).
  * RestartReporter — ASCII rst7 every N iterations (reference:
    blues/reporters.py:217-225).
  * ProgressReporter — one-line JSON progress file.

All reporters handle both single-state and replica-batched runs (replica 0
is written for trajectory formats; stats are averaged for stream rows).
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from .. import units
from ..core.amber_coords import write_rst7
from .logger import REPORT_LEVEL, add_report_level

logger = logging.getLogger("blues_tpu_torch.reporters")


def _np(a, batched_ndim=None):
    """``a`` as a numpy array (one host copy of a tensor); with
    ``batched_ndim``, replica 0's slice of an array of that many dims."""
    if batched_ndim is not None and a.ndim == batched_ndim:
        a = a[0]
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def box_to_lengths_angles(box):
    """(3,3) box-vector rows -> (lengths_nm (3,), angles_deg (3,)).

    Real cell geometry for trajectory metadata — a triclinic run must not
    write 90/90/90 (reference writes true lengths+angles,
    blues/formats.py:640-691). Angles follow the crystallographic
    convention: alpha = angle(b, c), beta = angle(a, c), gamma = angle(a, b).
    """
    box = np.asarray(box, np.float64)
    a, b, c = box[0], box[1], box[2]
    la, lb, lc = (np.linalg.norm(v) for v in (a, b, c))

    def ang(u, v, lu, lv):
        return float(np.degrees(np.arccos(np.clip(np.dot(u, v) / (lu * lv), -1.0, 1.0))))

    return (
        np.array([la, lb, lc]),
        np.array([ang(b, c, lb, lc), ang(a, c, la, lc), ang(a, b, la, lb)]),
    )


def _environment_provenance():
    """Host-environment capture for trajectory provenance (the reference
    dumps the conda environment into HDF5 attrs, blues/formats.py:384-473;
    here the interpreter, torch, CUDA, the card and the core packages)."""
    import platform
    import sys as _sys

    env = {
        "python": _sys.version,
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
    }
    for mod in ("numpy", "scipy", "h5py"):
        try:
            import importlib.metadata as md

            env[mod] = md.version(mod)
        except Exception:
            pass
    return env


def _iters_interval(report_interval: int, steps_per_iter: int) -> int:
    """Reference reportIntervals are in integrator steps
    (e.g. examples/rotmove_cuda.yml: reportInterval 2500 with nstepsMD
    10000); this driver reports at iteration granularity, so step-valued
    intervals are converted to the nearest iteration count."""
    if steps_per_iter > 0:
        return max(1, round(report_interval / steps_per_iter))
    return max(1, report_interval)


def _steps_per_iter(sim, source: str) -> int:
    """Integrator steps one driver iteration advances the given source by
    (ncmc reporters count propagation steps, md reporters MD steps) — the
    per-Simulation step accounting of the reference's attached reporters."""
    if source == "ncmc":
        return getattr(sim, "propSteps", sim.cfg.nstepsNC)
    return sim.cfg.nstepsMD


class BaseReporter:
    #: subclasses set these; interval conversion happens exactly once
    interval: int = 1
    source: str = "md"
    _interval_converted: bool = False

    def _interval_iters(self, sim) -> int:
        """Step-valued reportInterval -> iteration cadence, converted once
        on first use (re-dividing per call would collapse any cadence to 1)."""
        if not self._interval_converted:
            self.interval = _iters_interval(self.interval, _steps_per_iter(sim, self.source))
            self._interval_converted = True
        return self.interval

    def report(self, sim, iteration, stats, md_frames, ncmc_frames):
        raise NotImplementedError

    def close(self):
        pass


def _ncmc_frame_data(sim, ncmc_frames):
    """Unpack NCMCFrames -> (positions (K,N,3) of replica 0, per-frame work
    in kT, per-frame master lambda). Returns (None, None, None) if absent."""
    if ncmc_frames is None or getattr(ncmc_frames, "positions", None) is None:
        return None, None, None
    pos = _np(ncmc_frames.positions, 4)  # replica batch: write replica 0
    work = _np(ncmc_frames.work, 2)
    work = work / units.kT(sim.cfg.temperature)
    lams = np.asarray(getattr(sim, "ncmc_frame_lambdas", ()) or np.zeros(pos.shape[0]))
    if lams.shape[0] != pos.shape[0]:
        lams = np.zeros(pos.shape[0])
    return pos, work, lams


def _kinetic_and_temperature(sim):
    """(KE kJ/mol, T Kelvin) from the live state velocities; replica
    batches average. 1 Da (nm/ps)^2 = 1 kJ/mol exactly. dof counts moving
    atoms minus constraints (OpenMM StateDataReporter convention)."""
    m = np.asarray(sim.system.masses)
    v = _np(sim.state.velocities)
    ke = 0.5 * np.sum(m * np.sum(v * v, axis=-1), axis=-1)  # per replica
    ke = float(np.mean(ke))
    n_constraints = len(sim.system.constraints) if sim.system.constraints is not None else 0
    dof = max(3 * int((m > 0).sum()) - n_constraints, 1)
    kB = units.BOLTZMANN_KJMOL  # kJ/mol/K
    return ke, 2.0 * ke / (dof * kB)


def _box_volume_nm3(sim) -> float:
    box = _np(sim.state.box, 3)
    # triclinic reduced boxes are lower-triangular: det = diagonal product
    return float(abs(np.linalg.det(box)))


class StateDataReporter(BaseReporter):
    def __init__(
        self,
        title: str = "md",
        reportInterval: int = 1,
        totalSteps: int | None = None,
        step: bool = True,
        speed: bool = True,
        progress: bool = True,
        remainingTime: bool = True,
        currentIter: bool = True,
        protocolWork: bool = False,
        alchemicalLambda: bool = False,
        potentialEnergy: bool = True,
        kineticEnergy: bool = False,
        totalEnergy: bool = False,
        temperature: bool = False,
        volume: bool = False,
        density: bool = False,
        log: logging.Logger | None = None,
        source: str = "md",
    ):
        add_report_level()
        self.source = source
        self.title = title
        self.interval = max(int(reportInterval), 1)
        self.total_steps = totalSteps
        self.flags = dict(
            step=step, speed=speed, progress=progress, remainingTime=remainingTime,
            currentIter=currentIter, protocolWork=protocolWork,
            alchemicalLambda=alchemicalLambda, potentialEnergy=potentialEnergy,
            kineticEnergy=kineticEnergy, totalEnergy=totalEnergy,
            temperature=temperature, volume=volume, density=density,
        )
        self.log = log or logger
        self._t0 = None
        self._steps_done = 0
        self._header_done = False

    def report(self, sim, iteration, stats, md_frames, ncmc_frames):
        # step accounting follows the attached simulation, like the
        # reference's per-Simulation reporters (md counts MD steps, ncmc
        # counts propagation steps)
        steps_per_iter = _steps_per_iter(sim, self.source)
        self._steps_done += steps_per_iter
        interval = self._interval_iters(sim)
        if self._t0 is None:
            self._t0 = time.time()
            self._iters_timed = 0
            return
        self._iters_timed += 1
        if (iteration + 1) % interval:
            return
        cols = [f"[{self.title}]"]
        if self.flags["currentIter"]:
            cols.append(f"iter={iteration + 1}")
        if self.flags["step"]:
            cols.append(f"steps={self._steps_done}")
        pe = float(np.mean(_np(stats.md_potential)))
        if self.flags["potentialEnergy"]:
            cols.append(f"PE={pe:.2f} kJ/mol")
        # KE / temperature / totalEnergy from the live velocities (the
        # reference streams these from the OpenMM State,
        # blues/reporters.py:602-728); replica batches report the mean
        if self.flags["kineticEnergy"] or self.flags["temperature"] or self.flags["totalEnergy"]:
            ke, temp = _kinetic_and_temperature(sim)
            if self.flags["kineticEnergy"]:
                cols.append(f"KE={ke:.2f} kJ/mol")
            if self.flags["totalEnergy"]:
                cols.append(f"E={pe + ke:.2f} kJ/mol")
            if self.flags["temperature"]:
                cols.append(f"T={temp:.2f} K")
        if self.flags["volume"] or self.flags["density"]:
            vol = _box_volume_nm3(sim)
            if self.flags["volume"]:
                cols.append(f"V={vol:.3f} nm^3")
            if self.flags["density"]:
                # Da / nm^3 -> g/mL (1 Da/nm^3 = 1/602.214 g/mL)
                rho = float(np.sum(np.asarray(sim.system.masses))) / vol / 602.2140857
                cols.append(f"rho={rho:.4f} g/mL")
        if self.flags["protocolWork"]:
            w = float(np.mean(_np(stats.protocol_work))) / units.kT(
                sim.cfg.temperature
            )
            cols.append(f"work={w:.3f} kT")
        if self.flags["speed"]:
            elapsed = max(time.time() - self._t0, 1e-9)
            ps = self._iters_timed * steps_per_iter * sim.cfg.dt
            cols.append(f"speed={ps / elapsed * 86.4:.2f} ns/day")
        if self.flags["progress"] and self.total_steps:
            cols.append(f"progress={100.0 * self._steps_done / self.total_steps:.1f}%")
        if self.flags["remainingTime"] and self.total_steps:
            elapsed = time.time() - self._t0
            rate = self._steps_done / max(elapsed, 1e-9)
            remaining = (self.total_steps - self._steps_done) / max(rate, 1e-9)
            cols.append(f"remaining={remaining:.0f}s")
        acc = _np(stats.accepted)
        cols.append(f"acc={float(acc.mean()):.2f}")
        self.log.log(REPORT_LEVEL, "  ".join(cols))


class NetCDFReporter(BaseReporter):
    """AMBER NetCDF trajectory (+ protocolWork/alchemicalLambda for NCMC)."""

    def __init__(self, filename, reportInterval: int = 1, crds: bool = True,
                 protocolWork: bool = False, alchemicalLambda: bool = False,
                 frame_indices=(), source: str = "md"):
        self.filename = filename
        self.interval = max(int(reportInterval), 1)
        self.protocolWork = protocolWork
        self.alchemicalLambda = alchemicalLambda
        self.source = source  # 'md' -> md_frames, 'ncmc' -> ncmc snapshot frames
        #: which NCMC frames are collected is configured on the driver
        #: (SimulationConfig.ncmc_frame_indices, wired by create_simulation);
        #: kept here for provenance only
        self.frame_indices = tuple(frame_indices or ())
        if self.frame_indices:
            # frame_indices supersedes interval cadence (reference
            # blues/reporters.py:362-371): write the snapshots every iteration
            self.interval = 1
            self._interval_converted = True
        self._nc = None
        self._frame = 0

    def _init(self, n_atoms, box):
        from scipy.io import netcdf_file

        nc = netcdf_file(self.filename, "w", version=2, mmap=False)
        nc.Conventions = b"AMBER"
        nc.ConventionVersion = b"1.0"
        nc.application = b"blues_tpu_torch"
        nc.program = b"blues_tpu_torch"
        nc.programVersion = b"0.1.0"
        nc.title = b"blues_tpu_torch trajectory"
        nc.createDimension("frame", None)
        nc.createDimension("atom", n_atoms)
        nc.createDimension("spatial", 3)
        nc.createDimension("cell_spatial", 3)
        nc.createDimension("cell_angular", 3)
        v = nc.createVariable("coordinates", "f", ("frame", "atom", "spatial"))
        v.units = b"angstrom"
        t = nc.createVariable("time", "f", ("frame",))
        t.units = b"picosecond"
        if box is not None:
            cl = nc.createVariable("cell_lengths", "d", ("frame", "cell_spatial"))
            cl.units = b"angstrom"
            ca = nc.createVariable("cell_angles", "d", ("frame", "cell_angular"))
            ca.units = b"degree"
        if self.protocolWork:
            nc.createVariable("protocolWork", "f", ("frame",)).units = b"kT"
        if self.alchemicalLambda:
            nc.createVariable("alchemicalLambda", "f", ("frame",))
        self._nc = nc

    def report(self, sim, iteration, stats, md_frames, ncmc_frames):
        if (iteration + 1) % self._interval_iters(sim):
            return
        if self.source == "ncmc":
            frames, works, lams = _ncmc_frame_data(sim, ncmc_frames)
        else:
            frames = None if md_frames is None else _np(md_frames, 4)  # replica 0
            works = lams = None
        if frames is None:
            return
        box = _np(sim.state.box, 3)
        if self._nc is None:
            self._init(frames.shape[1], box)
        lengths, angles = box_to_lengths_angles(box)
        for k, fr in enumerate(frames):
            i = self._frame
            self._nc.variables["coordinates"][i] = fr * 10.0
            self._nc.variables["time"][i] = float(i)
            if "cell_lengths" in self._nc.variables:
                self._nc.variables["cell_lengths"][i] = lengths * 10.0
                self._nc.variables["cell_angles"][i] = angles
            if self.protocolWork:
                self._nc.variables["protocolWork"][i] = float(works[k]) if works is not None else 0.0
            if self.alchemicalLambda:
                self._nc.variables["alchemicalLambda"][i] = float(lams[k]) if lams is not None else 0.0
            self._frame += 1
        self._nc.flush()

    def close(self):
        if self._nc is not None:
            self._nc.close()
            self._nc = None


class HDF5Reporter(BaseReporter):
    """mdtraj-HDF5-style trajectory with BLUES extension fields."""

    def __init__(self, filename, reportInterval: int = 1, protocolWork: bool = True,
                 alchemicalLambda: bool = True, parameters=None, source: str = "ncmc",
                 frame_indices=()):
        self.filename = filename
        self.interval = max(int(reportInterval), 1)
        self.protocolWork = protocolWork
        self.alchemicalLambda = alchemicalLambda
        self.parameters = parameters
        self.source = source
        self.frame_indices = tuple(frame_indices or ())
        if self.frame_indices:
            self.interval = 1
            self._interval_converted = True
        self._h5 = None
        self._frame = 0

    def _init(self, n_atoms):
        import h5py

        h5 = h5py.File(self.filename, "w")
        h5.attrs["conventions"] = "Pande"
        h5.attrs["conventionVersion"] = "1.1"
        h5.attrs["program"] = "blues_tpu_torch"
        h5.attrs["programVersion"] = "0.1.0"
        h5.attrs["environment"] = json.dumps(_environment_provenance())
        if self.parameters is not None:
            h5.attrs["parameters"] = json.dumps(self.parameters, default=str)
        h5.create_dataset(
            "coordinates", shape=(0, n_atoms, 3), maxshape=(None, n_atoms, 3),
            dtype="f4", chunks=(8, n_atoms, 3),
        ).attrs["units"] = "nanometers"
        h5.create_dataset("time", shape=(0,), maxshape=(None,), dtype="f4")
        h5.create_dataset("cell_lengths", shape=(0, 3), maxshape=(None, 3), dtype="f4")
        h5.create_dataset("cell_angles", shape=(0, 3), maxshape=(None, 3), dtype="f4")
        if self.protocolWork:
            h5.create_dataset("protocolWork", shape=(0,), maxshape=(None,), dtype="f4")
        if self.alchemicalLambda:
            h5.create_dataset("alchemicalLambda", shape=(0,), maxshape=(None,), dtype="f4")
        self._h5 = h5

    def report(self, sim, iteration, stats, md_frames, ncmc_frames):
        if (iteration + 1) % self._interval_iters(sim):
            return
        if self.source == "ncmc":
            frames, works, lams = _ncmc_frame_data(sim, ncmc_frames)
        else:
            frames = None if md_frames is None else _np(md_frames, 4)
            works = lams = None
        if frames is None:
            return
        if self._h5 is None:
            self._init(frames.shape[1])
        box = _np(sim.state.box, 3)
        n_new = frames.shape[0]
        for name in ("coordinates", "time", "cell_lengths", "cell_angles",
                     "protocolWork", "alchemicalLambda"):
            if name in self._h5:
                ds = self._h5[name]
                ds.resize(self._frame + n_new, axis=0)
        lengths, angles = box_to_lengths_angles(box)
        for k, fr in enumerate(frames):
            i = self._frame
            self._h5["coordinates"][i] = fr
            self._h5["time"][i] = float(i)
            self._h5["cell_lengths"][i] = lengths
            self._h5["cell_angles"][i] = angles
            if self.protocolWork:
                self._h5["protocolWork"][i] = float(works[k]) if works is not None else 0.0
            if self.alchemicalLambda:
                self._h5["alchemicalLambda"][i] = float(lams[k]) if lams is not None else 0.0
            self._frame += 1
        self._h5.flush()

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None


class RestartReporter(BaseReporter):
    def __init__(self, filename, reportInterval: int = 1):
        self.filename = filename
        self.interval = max(int(reportInterval), 1)

    def report(self, sim, iteration, stats, md_frames, ncmc_frames):
        if (iteration + 1) % self._interval_iters(sim):
            return
        s = sim.state
        x, v, box = _np(s.positions, 3), _np(s.velocities, 3), _np(s.box, 3)
        write_rst7(self.filename, x, v, box, time=float(iteration + 1))


class ProgressReporter(BaseReporter):
    def __init__(self, filename, reportInterval: int = 1, totalSteps=None):
        self.filename = filename
        self.interval = max(int(reportInterval), 1)
        self.total_steps = totalSteps
        self._t0 = time.time()
        self._accepted = 0
        self._count = 0

    def report(self, sim, iteration, stats, md_frames, ncmc_frames):
        acc = _np(stats.accepted)
        self._accepted += float(acc.sum())
        self._count += acc.size
        if (iteration + 1) % self.interval:
            return
        with open(self.filename, "w") as f:
            json.dump(
                {
                    "iteration": iteration + 1,
                    "nIter": sim.cfg.nIter,
                    "acceptance": self._accepted / max(self._count, 1),
                    "elapsed_s": time.time() - self._t0,
                },
                f,
            )


class ReporterConfig:
    """YAML reporter-dict -> reporter objects (reference:
    blues/reporters.py:129-242). Keys: state, traj_netcdf, h5, restart,
    progress, stream."""

    def __init__(self, outfname, reporter_config: dict, logger_=None, source="md"):
        self.outfname = outfname
        self.cfg = dict(reporter_config or {})
        self.logger = logger_
        self.source = source
        self.trajectory_interval = (self.cfg.get("traj_netcdf") or {}).get(
            "reportInterval"
        )

    def makeReporters(self):
        reps = []
        c = self.cfg
        if "state" in c:
            reps.append(
                StateDataReporter(
                    title=self.source, log=self.logger, source=self.source,
                    **{k: v for k, v in (c["state"] or {}).items()},
                )
            )
        if "traj_netcdf" in c:
            kw = dict(c["traj_netcdf"] or {})
            reps.append(
                NetCDFReporter(f"{self.outfname}.nc", source=self.source, **kw)
            )
        if "h5" in c:
            reps.append(HDF5Reporter(f"{self.outfname}.h5", source=self.source, **(c["h5"] or {})))
        if "restart" in c:
            reps.append(RestartReporter(f"{self.outfname}.rst7", **(c["restart"] or {})))
        if "progress" in c:
            reps.append(ProgressReporter(f"{self.outfname}.progress", **(c["progress"] or {})))
        if "stream" in c:
            reps.append(
                StateDataReporter(log=self.logger, source=self.source, **(c["stream"] or {}))
            )
        return reps
