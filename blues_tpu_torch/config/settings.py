"""YAML configuration layer, schema-compatible with the reference.

The port's copy of ``blues_tpu.config.settings``. A config whose text is
JSON is read with ``json`` (YAML's ``safe_load`` reads such text as the same
dict); other text needs pyyaml, imported only then, so this module imports
without it. ``create_simulation`` builds the port's simulation on
``device`` (the card by default). Beyond the JAX package,
``sweep_row_group`` must be a positive integer.

Reimplements blues/settings.py: `Settings(yaml_or_path).asDict()` parses the
same YAML schema the reference uses (see reference:
examples/rotmove_cuda.yml) — output/logger sections, structure loading,
system build options (+ nested alchemical settings), freeze/restraints,
simulation parameters with `calculateNCMCSteps` reconciliation, and
md/ncmc reporter blocks. Differences by design:

  * quantity strings ('10 * angstroms') parse through a conversion table
    (blues_tpu.units.parse_quantity), not `eval` (reference
    blues/utils.py:180-199 and settings.py:205-230 use eval);
  * enum strings ('PME', 'HBonds') validate against lookup sets instead of
    eval onto simtk.openmm.app objects;
  * 'platform' is accepted but ignored (the device is ``create_simulation``'s
    argument).

`create_simulation(cfg, move)` assembles the full stack: prmtop/inpcrd ->
System (+ alchemical region, freeze, restraints) -> BLUESSimulation +
reporters.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Optional

from .. import units
from ..core.amber_coords import load_inpcrd
from ..core.device import DEFAULT_DEVICE
from ..core.prmtop import load_prmtop
from ..core.selection import amber_selection_to_atomidx
from ..core.system import AlchemicalRegion
from ..integrators.schedules import calculate_ncmc_steps
from ..reporters import ReporterConfig, init_logger

logger = logging.getLogger("blues_tpu_torch.settings")

_NONBONDED_METHODS = {"NoCutoff", "CutoffNonPeriodic", "CutoffPeriodic", "PME", "Ewald"}
_CONSTRAINT_OPTIONS = {"None", "HBonds", "AllBonds", "HAngles", None}

# --- strict section schemas (VERDICT r3 weak #5) ---------------------------
# The reference config layer maps every system key onto OpenMM app objects
# and fails loudly when its eval table misses (blues/settings.py:205-230).
# A schema-compatible layer that silently ignores physics-changing keys
# (e.g. implicitSolvent: OBC2 running PME/vacuum physics instead) is worse
# than one that errors — so unknown keys are errors, recognized-but-
# unsupported physics keys are errors naming the gap, and recognized
# no-op keys warn once.

#: system keys consumed by load_structure / create_simulation
_SYSTEM_KEYS = {
    "nonbondedMethod", "nonbondedCutoff", "switchDistance",
    "useSwitchingFunction", "constraints", "hydrogenMass",
    "ewaldErrorTolerance", "alchemical", "alchemical_pme_treatment",
    "suppress_warnings", "dispersion_correction", "implicitSolvent",
    "soluteDielectric", "solventDielectric", "implicitSolventKappa",
    "implicitSolventSaltConc",
}
#: reference keys accepted for YAML parity whose effect is inherent to this
#: engine or a constant-offset bookkeeping choice (warn, don't error):
#:   rigidWater=True — 'constraints: HBonds' already rigidifies Amber 3-site
#:     waters (H-H bond); splitDihedrals — force-group bookkeeping only;
#:   flexibleConstraints — adds the (constant at constrained length)
#:     harmonic terms of constrained bonds to the reported PE;
#:   removeCMMotion — no CMMotionRemover here (Langevin friction damps
#:     center-of-mass drift; sampling is unaffected).
_SYSTEM_KEYS_NOOP = {
    "rigidWater", "removeCMMotion", "flexibleConstraints", "splitDihedrals",
    "verbose",
}
#: simulation keys consumed by create_simulation (+ those injected by
#: calculate_ncmc_steps) and the performance knobs
_SIMULATION_KEYS = {
    "nIter", "nstepsNC", "nstepsMD", "temperature", "dt", "friction",
    "nprop", "propLambda", "moveStep", "propSteps", "splitting",
    "alchemical_functions", "pressure", "barostatInterval", "minimize",
    "frozen_cull_skin", "nlist_rebuild_interval", "nonbonded_backend",
    "max_steps_per_dispatch", "frozen_compact", "sweep_row_group",
}
#: reference simulation keys with no analog here (the device is
#: create_simulation's argument; OpenMM context properties do not exist)
_SIMULATION_KEYS_NOOP = {"platform", "properties", "verbose", "outfname"}
_FREEZE_KEYS = {"freeze_center", "freeze_distance", "freeze_solvent"}
_RESTRAINT_KEYS = {"selection", "weight"}
#: implemented generalized-Born models (reference accepts HCT/OBC1/OBC2/
#: GBn/GBn2 via parmed createSystem, blues/settings.py:205-230); anything
#: else must error rather than silently run vacuum/PME physics.
#: GBn/GBn2 (neck-corrected models) are not implemented — they error.
_GB_MODELS = frozenset({"HCT", "OBC1", "OBC2"})

#: keys parsed as quantities, with default units for bare numbers
#: (reference blues/settings.py:139-187 set_Units)
_QUANTITY_KEYS = {
    "dt": "picoseconds",
    "friction": "/picosecond",
    "temperature": "kelvin",
    "pressure": "bar",
    "hydrogenMass": "daltons",
    "nonbondedCutoff": "angstroms",
    "switchDistance": "angstroms",
    "freeze_distance": "angstroms",
    "radius": "angstroms",
    "weight": None,  # kcal/mol/A^2 restraint weight, kept numeric
}


class Settings:
    """Parse + validate a YAML config (path, literal YAML string, or dict)."""

    def __init__(self, config):
        if isinstance(config, dict):
            cfg = dict(config)
        else:
            cfg = self._load_yaml(config)
        self.config = self._set_parameters(cfg)

    @staticmethod
    def _load_yaml(yaml_or_path: str) -> dict:
        """Accept a filesystem path or literal YAML/JSON text (reference:
        blues/settings.py:33-57)."""
        if os.path.exists(yaml_or_path):
            with open(yaml_or_path) as f:
                text = f.read()
        elif "\n" not in yaml_or_path:
            # a path-like string that doesn't exist is a user error, not YAML
            raise FileNotFoundError(f"config file not found: {yaml_or_path}")
        else:
            text = yaml_or_path
        try:
            loaded = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml
            except ImportError:
                raise ImportError(
                    "this config is YAML, and reading YAML needs pyyaml, which is not installed; "
                    "install pyyaml or write the config as JSON"
                ) from None
            loaded = yaml.safe_load(text)
        if not isinstance(loaded, dict):
            raise ValueError("config YAML must define a mapping of sections")
        return loaded

    # --- pipeline (reference set_Parameters, blues/settings.py:286-307) ----
    def _set_parameters(self, cfg: dict) -> dict:
        cfg.setdefault("output_dir", ".")
        cfg.setdefault("outfname", "blues_tpu_torch")
        os.makedirs(cfg["output_dir"], exist_ok=True)
        cfg["outfname_path"] = os.path.join(cfg["output_dir"], cfg["outfname"])

        log_cfg = cfg.get("logger", {}) or {}
        level = getattr(logging, str(log_cfg.get("level", "info")).upper(), logging.INFO)
        cfg["Logger"] = init_logger(
            logging.getLogger("blues_tpu_torch"),
            level=level,
            stream=bool(log_cfg.get("stream", True)),
            outfname=cfg["outfname_path"] if log_cfg.get("file", False) else None,
        )

        self._set_units(cfg)
        self._validate_system(cfg)
        self._set_ncmc_steps(cfg)
        return cfg

    def _set_units(self, cfg: dict):
        def convert(section: dict):
            for k, v in list(section.items()):
                if isinstance(v, dict):
                    convert(v)
                elif k in _QUANTITY_KEYS:
                    unit = _QUANTITY_KEYS[k]
                    if isinstance(v, str) or unit is not None:
                        section[k] = units.parse_quantity(v, unit)

        for sec in ("system", "simulation", "freeze", "restraints"):
            if isinstance(cfg.get(sec), dict):
                convert(cfg[sec])

    @staticmethod
    def _check_keys(section: dict, name: str, known: set, noop: set = frozenset()):
        unknown = set(section) - known - noop
        if unknown:
            raise ValueError(
                f"unrecognized {name} key(s) {sorted(unknown)}; "
                f"supported: {sorted(known)}"
            )
        ignored = set(section) & noop
        if ignored:
            logger.warning(
                "%s key(s) %s accepted for reference-YAML parity but have "
                "no effect on this engine", name, sorted(ignored)
            )

    def _validate_system(self, cfg: dict):
        sysc = cfg.get("system", {}) or {}
        self._check_keys(sysc, "system", _SYSTEM_KEYS, _SYSTEM_KEYS_NOOP)
        nbm = sysc.get("nonbondedMethod", "NoCutoff")
        if nbm not in _NONBONDED_METHODS:
            raise ValueError(
                f"unknown nonbondedMethod {nbm!r}; options: {sorted(_NONBONDED_METHODS)}"
            )
        cons = sysc.get("constraints", "HBonds")
        if cons not in _CONSTRAINT_OPTIONS:
            raise ValueError(f"unknown constraints option {cons!r}")
        if sysc.get("rigidWater") is False:
            raise ValueError(
                "rigidWater: False is unsupported (waters are rigidified by "
                "the HBonds constraint set; flexible water needs "
                "constraints: None and is untested on this engine)"
            )
        imp = sysc.get("implicitSolvent")
        if imp is not None and str(imp) not in _GB_MODELS:
            raise ValueError(
                f"implicitSolvent {imp!r} is not supported; implemented "
                f"GB models: {sorted(_GB_MODELS)}"
            )
        if imp is not None and str(sysc.get("nonbondedMethod", "NoCutoff")) != (
            "NoCutoff"
        ):
            raise ValueError(
                "implicitSolvent requires nonbondedMethod: NoCutoff "
                "(periodic methods are invalid with GB — OpenMM "
                "createSystem rejects them too — and the truncated "
                "CutoffNonPeriodic GBSAOBC variant is not implemented)"
            )
        sim = cfg.get("simulation", {}) or {}
        self._check_keys(sim, "simulation", _SIMULATION_KEYS, _SIMULATION_KEYS_NOOP)
        frz = cfg.get("freeze")
        if isinstance(frz, dict):
            self._check_keys(frz, "freeze", _FREEZE_KEYS)
        rst = cfg.get("restraints")
        if isinstance(rst, dict):
            self._check_keys(rst, "restraints", _RESTRAINT_KEYS)
        # validated here, unlike the JAX package, which takes the value as it is
        group = sim.get("sweep_row_group")
        if group is not None and (isinstance(group, bool) or not isinstance(group, int) or group < 1):
            raise ValueError(f"sweep_row_group must be a positive integer, got {group!r}")

    def _set_ncmc_steps(self, cfg: dict):
        sim = cfg.get("simulation", {}) or {}
        if "nstepsNC" in sim:
            ncmc = calculate_ncmc_steps(
                int(sim["nstepsNC"]),
                int(sim.get("nprop", 1)),
                float(sim.get("propLambda", 0.3)),
            )
            sim.update(ncmc)
            cfg["simulation"] = sim

    def asDict(self) -> dict:
        return self.config

    def asYAML(self) -> str:
        import yaml

        clean = {k: v for k, v in self.config.items() if k != "Logger"}
        return yaml.safe_dump(clean, default_flow_style=False)

    def asJSON(self) -> str:
        clean = {k: v for k, v in self.config.items() if k != "Logger"}
        return json.dumps(clean, default=str, indent=2)


def load_structure(cfg: dict):
    """Build (System, positions, velocities|None) from the structure +
    system sections (reference: blues/settings.py:59-90 set_Structure +
    SystemFactory.generateSystem)."""
    struct = cfg.get("structure", {}) or {}
    sysc = cfg.get("system", {}) or {}
    prmtop_path = struct.get("filename") or struct.get("prmtop")
    if prmtop_path is None:
        raise ValueError("structure.filename (prmtop) required")
    # implicit solvent (reference set_Apps maps the model string onto
    # simtk.openmm.app objects consumed by parmed createSystem,
    # blues/settings.py:205-230; here it selects the GB term in
    # potentials/gb.py). Kappa: either given directly (1/nm) or derived
    # from implicitSolventSaltConc with parmed createSystem's formula
    # kappa[1/A] = 50.33355*sqrt(c/(eps_out*T)) scaled by 0.73923 (the
    # GB-specific electrostatic factor), converted to 1/nm.
    imp = sysc.get("implicitSolvent")
    gb_kwargs = {}
    if imp is not None:
        kappa = sysc.get("implicitSolventKappa")
        if kappa is None:
            salt = float(sysc.get("implicitSolventSaltConc", 0.0) or 0.0)
            kappa = 0.0
            if salt > 0.0:
                temp = float(
                    (cfg.get("simulation", {}) or {}).get("temperature", 298.15)
                )
                eps_out = float(sysc.get("solventDielectric", 78.5))
                kappa = (
                    10.0 * 0.73923 * 50.33355 * math.sqrt(salt / (eps_out * temp))
                )
        gb_kwargs = dict(
            implicit_solvent=str(imp),
            implicit_solvent_kappa=float(kappa),
            solute_dielectric=float(sysc.get("soluteDielectric", 1.0)),
            solvent_dielectric=float(sysc.get("solventDielectric", 78.5)),
        )
    system = load_prmtop(
        prmtop_path,
        constraints=str(sysc.get("constraints", "HBonds")),
        hydrogen_mass=sysc.get("hydrogenMass"),
        **gb_kwargs,
    )
    positions = velocities = None
    box = None
    if struct.get("restart"):
        crd = load_inpcrd(struct["restart"])
        positions, velocities, box = crd.positions, crd.velocities, crd.box
    elif struct.get("xyz") or struct.get("inpcrd"):
        crd = load_inpcrd(struct.get("xyz") or struct.get("inpcrd"))
        positions, box = crd.positions, crd.box
    if box is not None:
        system = system.replace(box=box)

    # alchemical region over the ligand selection; treatment keys belong to
    # the simulation config, not the region (reference generateAlchSystem
    # kwargs, blues/simulation.py:221-317)
    alch_cfg = dict(sysc.get("alchemical", {}) or {})
    for treatment_key in ("alchemical_pme_treatment", "suppress_warnings"):
        if treatment_key in alch_cfg:
            sysc[treatment_key] = alch_cfg.pop(treatment_key)
    lig_resname = (cfg.get("ligand", {}) or {}).get("resname", "LIG")
    lig = system.topology.select_resname(lig_resname)
    if len(lig):
        system = system.replace(
            alchemical=AlchemicalRegion(atoms=lig, **alch_cfg)
        )

    # freeze section (reference SystemFactory.freeze_radius,
    # blues/simulation.py:394-480); selections are Amber masks
    frz = cfg.get("freeze")
    if frz and positions is not None:
        center = amber_selection_to_atomidx(
            system.topology, str(frz.get("freeze_center", ":LIG")), positions
        )
        # freeze_solvent is a residue mask like ':HOH,NA,CL' (reference
        # default, blues/simulation.py:400): those residues freeze even
        # inside the radius
        solvent_mask = str(frz.get("freeze_solvent", ":HOH,NA,CL"))
        solvent_resnames = tuple(
            r.strip() for r in solvent_mask.lstrip(":").split(",") if r.strip()
        )
        system = system.freeze_radius(
            positions,
            center,
            float(frz.get("freeze_distance", 0.5)),
            solvent_resnames=solvent_resnames,
        )
    # restraints section (reference SystemFactory.restrain_positions)
    rst = cfg.get("restraints")
    if rst and positions is not None:
        idx = amber_selection_to_atomidx(
            system.topology, str(rst.get("selection", ":LIG")), positions
        )
        system = system.restrain_positions(
            positions, idx, float(rst.get("weight", 5.0))
        )
    return system, positions, velocities


def create_simulation(config, move=None, n_replicas: int = 1, device=DEFAULT_DEVICE, seed=None):
    """YAML/JSON/dict -> (BLUESSimulation, md_reporters, ncmc_reporters).

    The full reference startup call stack (SURVEY.md 3.1) in one call, on
    ``device``. If move is None, a RandomLigandRotationMove on resname LIG
    is built (the reference example flow, blues/example.py:7-29). The
    random stream is seeded with ``seed``, else from the clock, as the JAX
    package draws its key.
    """
    from ..moves import MoveEngine, RandomLigandRotationMove
    from ..simulation import BLUESSimulation, SimulationConfig

    cfg = Settings(config).asDict() if not isinstance(config, Settings) else config.asDict()
    system, positions, velocities = load_structure(cfg)
    sim_cfg = cfg.get("simulation", {}) or {}
    sysc = cfg.get("system", {}) or {}

    if move is None:
        lig_resname = (cfg.get("ligand", {}) or {}).get("resname", "LIG")
        lig = system.topology.select_resname(lig_resname)
        move = MoveEngine(RandomLigandRotationMove(lig, system.masses))

    nbm = sysc.get("nonbondedMethod", "NoCutoff")
    if nbm == "Ewald":
        nbm = "PME"

    # NCMC snapshot schedule: union of the ncmc reporters' frame_indices
    # (reference sentinel semantics, blues/settings.py:271-277)
    frame_indices = set()
    for block in (cfg.get("ncmc_reporters", {}) or {}).values():
        if isinstance(block, dict) and block.get("frame_indices"):
            frame_indices.update(block["frame_indices"])

    pressure = sim_cfg.get("pressure")
    config_obj = SimulationConfig(
        nIter=int(sim_cfg.get("nIter", 100)),
        nstepsNC=int(sim_cfg.get("nstepsNC", 100)),
        nstepsMD=int(sim_cfg.get("nstepsMD", 100)),
        temperature=float(sim_cfg.get("temperature", 300.0)),
        dt=float(sim_cfg.get("dt", 0.002)),
        friction=float(sim_cfg.get("friction", 1.0)),
        nprop=int(sim_cfg.get("nprop", 1)),
        propLambda=float(sim_cfg.get("propLambda", 0.3)),
        moveStep=sim_cfg.get("moveStep"),
        splitting=str(sim_cfg.get("splitting", "H V R O R V H")),
        alchemical_functions=sim_cfg.get("alchemical_functions"),
        nonbonded_method=nbm,
        cutoff=float(sysc.get("nonbondedCutoff", 1.0)),
        # switchDistance is honored only with useSwitchingFunction (OpenMM
        # createSystem semantics the reference forwards)
        switch_distance=(
            float(sysc["switchDistance"])
            if sysc.get("useSwitchingFunction") and sysc.get("switchDistance")
            else None
        ),
        ewald_tolerance=float(sysc.get("ewaldErrorTolerance", 5e-4)),
        alchemical_pme_treatment=str(
            sysc.get("alchemical_pme_treatment", "direct-space")
        ),
        md_report_interval=_md_frame_interval(cfg, int(sim_cfg.get("nstepsMD", 100))),
        # the reference adds a MonteCarloBarostat whenever 'pressure' is
        # configured (blues/simulation.py:602-626); NPT applies to MD only
        pressure=float(pressure) if pressure is not None else None,
        barostat_frequency=int(sim_cfg.get("barostatInterval", 25)),
        ncmc_frame_indices=tuple(sorted(frame_indices)) or None,
        n_replicas=n_replicas,
        # performance knobs (no reference analog): frozen-system
        # pair-column culling and verlet-list rebuild cadence
        frozen_cull_skin=(
            None
            if sim_cfg.get("frozen_cull_skin") is None
            and "frozen_cull_skin" in sim_cfg
            else float(sim_cfg.get("frozen_cull_skin", 0.45))
        ),
        nlist_rebuild_interval=int(sim_cfg.get("nlist_rebuild_interval", 10)),
        nonbonded_backend=str(sim_cfg.get("nonbonded_backend", "auto")),
        max_steps_per_dispatch=(
            int(sim_cfg["max_steps_per_dispatch"])
            if sim_cfg.get("max_steps_per_dispatch")
            else None
        ),
        frozen_compact=sim_cfg.get("frozen_compact", "auto"),
        # per-row-group column culling for the sweep kernel (Morton groups
        # of N mobile rows, each with its own culled column set)
        sweep_row_group=(
            int(sim_cfg["sweep_row_group"])
            if sim_cfg.get("sweep_row_group")
            else None
        ),
    )
    sim = BLUESSimulation(system, move, config_obj, device=device)
    if positions is not None:
        seed = int(time.time_ns() % (2**31)) if seed is None else int(seed)
        sim.initialize(positions, seed=seed, velocities=velocities if n_replicas == 1 else None)
        min_steps = int(sim_cfg.get("minimize", 0) or 0)
        if min_steps:
            sim.minimize(min_steps)

    out = cfg["outfname_path"]
    log = cfg.get("Logger")
    md_reps = ReporterConfig(out + "-md", cfg.get("md_reporters", {}), log, source="md").makeReporters()
    ncmc_reps = ReporterConfig(out + "-ncmc", cfg.get("ncmc_reporters", {}), log, source="ncmc").makeReporters()
    return sim, md_reps, ncmc_reps


def _md_frame_interval(cfg, nsteps_md: int) -> Optional[int]:
    md_reps = cfg.get("md_reporters", {}) or {}
    traj = md_reps.get("traj_netcdf")
    if not traj or "reportInterval" not in traj:
        return None
    interval = int(traj["reportInterval"])
    if interval >= nsteps_md:
        return nsteps_md
    # frames collected every `interval` MD steps within the iteration
    while nsteps_md % interval:
        interval += 1
    return interval
