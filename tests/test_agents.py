"""Agent-layer tests: parser (rule-based + fake LLM), dispatcher routing,
orchestrator end-to-end with the local toolset (hermetic — no network)."""

import asyncio
import json
import os

import numpy as np
import pytest

from pde_solver.agents.llm import FakeLLM, extract_json_block
from pde_solver.agents.parser_agent import PDEParserAgent, rule_based_parse, normalize_params_dict
from pde_solver.agents.dispatcher_agent import DispatcherAgent, normalize_geometry
from pde_solver.agents.orchestrator import MultiAgentOrchestrator
from pde_solver.agents.memory import ConversationMemory
from pde_solver.schema import PDEParameters


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# ----------------------------------------------------------------------
# Parser
# ----------------------------------------------------------------------

def test_rule_parse_1d_rod():
    p = rule_based_parse(
        "Solve 1D heat transfer in a 2 meter rod, left end at 20°C, right end at 0°C")
    assert p["pde_type"] == "heat"
    assert p["dim"] == 1
    assert p["domain_size"]["length"] == 2.0
    assert p["bc_values"]["T_left"] == 20.0
    assert p["bc_values"]["T_right"] == 0.0


def test_rule_parse_2d_plate_initial():
    p = rule_based_parse(
        "Simulate heat diffusion in a 1m x 1m plate with initial temperature 10°C")
    assert p["dim"] == 2
    assert p["domain_size"] == {"Lx": 1.0, "Ly": 1.0}
    assert p["initial_value"] == 10.0


def test_rule_parse_elasticity_3d_gravity():
    p = rule_based_parse(
        "3D elasticity problem on a 1m x 0.2m x 0.2m box with gravity, "
        "Young's modulus 210 GPa, Poisson's ratio 0.3")
    assert p["pde_type"] == "elasticity"
    assert p["dim"] == 3
    assert p["domain_size"] == {"Lx": 1.0, "Ly": 0.2, "Lz": 0.2}
    assert p["young_modulus"] == 210e9
    assert p["poisson_ratio"] == 0.3
    assert p["material_params"]["gravity"] is True


def test_rule_parse_cylinder_radial():
    p = rule_based_parse(
        "Steady heat conduction in a cylinder with inner radius 0.1 m and outer "
        "radius 1 m, inner surface at 100°C, outer at 20°C")
    assert p["geometry_type"] == "cylinder"
    assert p["dim"] == 1
    assert p["geometry_params"] == {"r_inner": 0.1, "r_outer": 1.0}
    assert p["bc_values"]["T_inner"] == 100.0
    assert p["bc_values"]["T_outer"] == 20.0
    assert p["steady"] is True


def test_rule_parse_source_and_steps():
    p = rule_based_parse("heat a 1m rod with a heat source of 50, 100 steps, dt 0.005")
    assert p["source_type"] == "constant" and p["source_value"] == 50.0
    assert p["num_steps"] == 100 and p["dt"] == 0.005


def test_parser_with_fake_llm_fenced_json():
    llm = FakeLLM(responses=[
        'Sure! ```json\n{"pde_type": "heat", "Dimension": 2, '
        '"domain": {"Lx": 3.0, "Ly": 1.5}, "thermal_diffusivity": {"value": 0.5}}\n```'])
    agent = PDEParserAgent(llm=llm)
    params, source = agent.parse_with_provenance("whatever")
    assert source == "llm"
    assert params.dim == 2
    assert params.domain_size == {"Lx": 3.0, "Ly": 1.5}
    assert params.diffusivity == 0.5


def test_parser_falls_back_to_rules_on_garbage_llm():
    llm = FakeLLM(responses=["I cannot answer that."])
    agent = PDEParserAgent(llm=llm)
    params, source = agent.parse_with_provenance(
        "Solve 1D heat in a 2 meter rod, left end at 20°C, right end at 0°C")
    assert source == "rules"
    assert params.domain_size["length"] == 2.0


def test_normalize_drops_unknown_and_coerces():
    out = normalize_params_dict({
        "pde_type": "heat", "bogus_key": 1, "nx": "64", "steady": "true",
        "bc_values": {"T_left": 5},
    })
    assert "bogus_key" not in out
    assert out["nx"] == 64
    assert out["steady"] is True


def test_extract_json_block_variants():
    assert extract_json_block('{"a": 1}') == {"a": 1}
    assert extract_json_block('bla ```json\n{"a": 1}\n``` done') == {"a": 1}
    assert extract_json_block('prefix {"a": {"b": 2}} suffix') == {"a": {"b": 2}}
    assert extract_json_block("no json here") is None


# ----------------------------------------------------------------------
# Dispatcher routing
# ----------------------------------------------------------------------

def test_routing_table():
    d = DispatcherAgent()
    cases = [
        (PDEParameters(pde_type="heat", dim=1), "solve_heat_1D"),
        (PDEParameters(pde_type="heat", dim=1, geometry_type="pipe"),
         "solve_heat_1D_cylindrical"),
        (PDEParameters(pde_type="heat", dim=1, geometry_type="ball"),
         "solve_heat_1D_spherical"),
        (PDEParameters(pde_type="heat", dim=2), "solve_heat_2D"),
        (PDEParameters(pde_type="heat", dim=2, coordinate_system="cylindrical"),
         "solve_heat_2D_cylindrical"),
        (PDEParameters(pde_type="heat", dim=2, geometry_type="sphere"),
         "solve_heat_2D_spherical"),
        (PDEParameters(pde_type="heat", dim=3), "solve_heat_3D"),
        (PDEParameters(pde_type="heat", dim=3, geometry_type="sphere"),
         "solve_heat_3D_spherical"),
        (PDEParameters(pde_type="elasticity", dim=1), "solve_elasticity_1D_static"),
        (PDEParameters(pde_type="elasticity", dim=2), "solve_elasticity_2D_static"),
        (PDEParameters(pde_type="elasticity", dim=3), "solve_elasticity_3D_static"),
    ]
    for params, expected in cases:
        name, _ = d.route(params)
        assert name == expected, (params, name, expected)


def test_elastodynamics_routing_opt_in():
    """'vibration' phrasing routes 3D elasticity to the Newmark extension
    tool; reference-style static queries keep routing to the static tool
    even when a parser marks them transient (steady=False alone must NOT
    flip the route — only the explicit 'dynamic' note does)."""
    d = DispatcherAgent()
    parsed = rule_based_parse(
        "simulate the vibration of a 1 m steel cantilever in 3d, "
        "time step 0.001, 20 steps")
    assert "dynamic" in parsed.get("notes", [])
    params = PDEParameters.from_dict({**parsed, "dim": 3})
    name, args = d.route(params)
    assert name == "solve_elasticity_3D_dynamic"
    assert args["dt"] == 0.001 and args["num_steps"] == 20
    assert args["rho"] == 7800.0 and "quantity" not in args

    static = PDEParameters(pde_type="elasticity", dim=3, steady=False)
    name, _ = d.route(static)
    assert name == "solve_elasticity_3D_static"


def test_geometry_inference_from_domain_notation():
    assert normalize_geometry(PDEParameters(domain_size={"r1": 0.1, "r2": 1, "h": 2})) == "cylinder"
    assert normalize_geometry(PDEParameters(domain_size={"r2": 1.0})) == "sphere"
    assert normalize_geometry(PDEParameters(domain_size={"Lx": 1.0})) == "box"


def test_3d_cylinder_r1r2h_mapping_and_core():
    d = DispatcherAgent()
    params = PDEParameters(pde_type="heat", dim=3, geometry_type="cylinder",
                           domain_size={"r1": 0.2, "r2": 0.5, "h": 3.0},
                           core_diffusivity=10.0)
    name, args = d.route(params)
    assert name == "solve_heat_3D"
    assert args["geometry_type"] == "cylinder"
    assert args["Lx"] == 3.0               # Lx = height
    assert args["cylinder_radius"] == 0.5  # = r2
    assert args["core_radius"] == 0.2      # hollow cylinder: core = r1
    assert args["core_diffusivity"] == 10.0


def test_3d_solid_cylinder_core_default_30pct():
    d = DispatcherAgent()
    params = PDEParameters(pde_type="heat", dim=3, geometry_type="cylinder",
                           domain_size={"r1": 0.0, "r2": 1.0, "h": 2.0},
                           core_diffusivity=5.0)
    _, args = d.route(params)
    assert args["core_radius"] == pytest.approx(0.3)


def test_dt_numsteps_heuristic():
    d = DispatcherAgent()
    params = PDEParameters(pde_type="heat", dim=1,
                           domain_size={"length": 2.0}, diffusivity=1.0)
    _, args = d.route(params)
    # t_char = 4/2 = 2; dt = min(2/200, 0.01) = 0.01; steps = max(200, 200)
    assert args["dt"] == 0.01
    assert args["num_steps"] == 200


def test_elasticity_gravity_body_force():
    d = DispatcherAgent()
    params = PDEParameters(pde_type="elasticity", dim=3,
                           domain_size={"Lx": 1, "Ly": 0.2, "Lz": 0.2},
                           material_params={"gravity": True}, density=7800.0)
    _, args = d.route(params)
    assert args["body_fz"] == pytest.approx(-9.81 * 7800.0)
    params2 = PDEParameters(pde_type="elasticity", dim=2,
                            material_params={"gravity": True})
    _, args2 = d.route(params2)
    assert args2["body_fy"] == pytest.approx(-9.81 * 7800.0)  # default density


def test_explicit_zero_bc_preserved():
    d = DispatcherAgent()
    params = PDEParameters(pde_type="heat", dim=1,
                           bc_values={"T_left": 0.0, "T_right": 50.0})
    _, args = d.route(params)
    assert args["T_left"] == 0.0 and args["T_right"] == 50.0


def test_unsupported_pde_type_error_envelope():
    # advection and poisson graduated to supported routes; the envelope
    # contract is checked with a genuinely unsupported type
    d = DispatcherAgent()
    res = run(d.dispatch(PDEParameters(pde_type="schrodinger", dim=1)))
    assert "error" in res and "schrodinger" in res["error"]


# ----------------------------------------------------------------------
# Orchestrator end-to-end (hermetic)
# ----------------------------------------------------------------------

@pytest.fixture()
def orch(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        yield MultiAgentOrchestrator(llm=None, memory_file=str(tmp_path / "mem.json"))
    finally:
        os.chdir(cwd)


def test_orchestrator_greeting(orch):
    res = run(orch.solve("hello there"))
    assert res["status"] == "greeting"
    assert res["html_path"] is None


def test_orchestrator_full_solve_and_followup(orch):
    res = run(orch.solve(
        "Solve 1D heat transfer in a 2 meter rod with 16 nodes, left end at "
        "20°C, right end at 0°C, 5 steps"))
    assert "error" not in res, res
    assert os.path.exists(res["data_file"])
    assert os.path.exists(res["html_path"])
    assert res["pde_params"]["dim"] == 1
    assert "Simulation Summary" in res["summary"]

    # follow-up: change one boundary, everything else preserved
    res2 = run(orch.solve("change the left boundary to 50"))
    assert "error" not in res2, res2
    assert res2["pde_params"]["bc_values"]["T_left"] == 50.0
    assert res2["pde_params"]["bc_values"]["T_right"] == 0.0
    assert res2["pde_params"]["domain_size"]["length"] == 2.0
    assert res2["pde_params"]["num_steps"] == 5


def test_orchestrator_memory_persistence(orch, tmp_path):
    run(orch.solve("Solve 1D heat in a 1 meter rod, 8 nodes, 2 steps, left end at 5°C"))
    mem2 = ConversationMemory(persist_file=str(tmp_path / "mem.json"))
    assert mem2.current_simulation is not None
    assert mem2.current_simulation.pde_params["dim"] == 1


def test_orchestrator_llm_validation_rejects_non_pde(tmp_path):
    llm = FakeLLM(responses=[
        json.dumps({"is_pde_problem": False, "justification": "It is a joke request."}),
    ])
    orch = MultiAgentOrchestrator(llm=llm, memory_file=None)
    res = run(orch.solve("solve me a funny joke equation"))
    assert res["status"] == "not_pde"


def test_orchestrator_normalize_domain_nested(orch):
    out = orch._normalize_domain_size({"domain_size": 2.5}, 2, "a 2m x 1m plate")
    assert out == {"Lx": 2.0, "Ly": 1.0}
    out2 = orch._normalize_domain_size({"domain_size": 2.5}, 3, "no dims here")
    assert out2 == {"Lx": 2.5, "Ly": 2.5, "Lz": 2.5}


def test_crank_nicolson_opt_in_via_notes():
    """A 'crank-nicolson' query flips SolverConfig.theta for the solve only
    (VERDICT r1 item 7 — frozen api.py signatures stay reference-identical)."""
    import asyncio

    from pde_solver.agents.dispatcher_agent import DispatcherAgent
    from pde_solver.agents.parser_agent import rule_based_parse
    from pde_solver.config import get_config
    from pde_solver.schema import PDEParameters

    parsed = rule_based_parse(
        "solve heat in a 1 m x 1 m plate with crank-nicolson stepping, "
        "boundary at 0 C, initial temperature 20 C, 4 steps")
    assert parsed.get("notes") == ["time_scheme:crank_nicolson"]

    seen = {}

    class SpyToolSet:
        async def call(self, name, args):
            if name.startswith("solve_"):
                seen["theta"] = get_config().theta
                seen["name"] = name
                from pde_solver import api
                return api.solve_heat_2D(nx=6, ny=6, num_steps=2,
                                         data_dir="data").__dict__
            from pde_solver import api
            return getattr(api, name)(**args).__dict__

        async def tool_names(self):
            return ["solve_heat_2D", "plot_time_series_field_from_file"]

    agent = DispatcherAgent(toolset=SpyToolSet())
    params = PDEParameters.from_dict(parsed)
    out = asyncio.run(agent.dispatch(params))
    assert "error" not in out, out.get("error")
    assert seen["theta"] == 0.5          # CN active during the solve
    assert get_config().theta == 1.0     # restored afterwards


# ----------------------------------------------------------------------
# Parser phrasing coverage (VERDICT r2 item 9: wall-thickness cylinders,
# mixed-unit sentences, per-face BC lists, reference prompt conventions)
# ----------------------------------------------------------------------

def test_rule_parse_hollow_cylinder_wall_thickness():
    p = rule_based_parse(
        "steady heat in a hollow cylinder with inner radius 5 cm and a "
        "2 cm wall, inner surface at 100°C, outer surface at 20°C")
    assert p["geometry_type"] == "cylinder"
    gp = p["geometry_params"]
    assert gp["r_inner"] == pytest.approx(0.05)
    assert gp["r_outer"] == pytest.approx(0.07)
    assert p["bc_values"] == {"T_inner": 100.0, "T_outer": 20.0}
    assert p["steady"] is True


def test_rule_parse_wall_thickness_from_outer():
    p = rule_based_parse(
        "pipe with outer radius 10 cm and wall thickness of 3 cm")
    gp = p["geometry_params"]
    assert gp["r_outer"] == pytest.approx(0.10)
    assert gp["r_inner"] == pytest.approx(0.07)


def test_rule_parse_hollow_single_radius_becomes_outer():
    p = rule_based_parse("hollow cylinder of radius 0.5 m, inner wall at 80")
    assert p["geometry_params"]["r_outer"] == pytest.approx(0.5)
    assert "cylinder_radius" not in p["geometry_params"]


def test_rule_parse_sphere_diameter():
    p = rule_based_parse("heat conduction in a sphere with diameter 40 cm")
    assert p["geometry_type"] == "sphere"
    assert p["geometry_params"]["sphere_radius"] == pytest.approx(0.2)


def test_rule_parse_mixed_units_one_sentence():
    p = rule_based_parse(
        "a 50 cm rod with 25 nodes, time step of 0.01, left end 100°C "
        "and right end 0°C")
    assert p["domain_size"]["length"] == pytest.approx(0.5)
    assert p["nx"] == 25
    assert p["dt"] == pytest.approx(0.01)
    assert p["bc_values"]["T_left"] == 100.0


def test_rule_parse_bare_thickness_is_not_length():
    """Reference CRITICAL rule (pde_parser_agent.py:424-429): '30nm thick'
    is a material cross-section, never the domain length."""
    p = rule_based_parse("heat in a 30 nm thick conductor, 100 steps")
    assert "length" not in (p.get("domain_size") or {})
    assert any("Thickness mentioned" in n for n in p.get("notes", []))
    assert p["num_steps"] == 100


def test_rule_parse_both_ends():
    p = rule_based_parse("a 1 m rod with both ends held at 0°C, "
                         "initial temperature of 50°C")
    assert p["bc_values"]["T_left"] == 0.0
    assert p["bc_values"]["T_right"] == 0.0
    assert p["initial_value"] == 50.0


def test_rule_parse_ends_pairwise():
    p = rule_based_parse("2 m bar, ends at 100 and 0 degrees")
    assert p["bc_values"]["T_left"] == 100.0
    assert p["bc_values"]["T_right"] == 0.0


def test_rule_parse_all_faces_boundary():
    p = rule_based_parse(
        "3-d cube with all six faces at 25°C, initially 100°C")
    assert p["dim"] == 3
    assert p["bc_values"]["T_boundary"] == 25.0


def test_rule_parse_modulus_of_elasticity_units():
    p = rule_based_parse(
        "stress in a steel plate, modulus of elasticity 200 GPa, "
        "Poisson's ratio 0.3, plane strain")
    assert p["young_modulus"] == pytest.approx(200e9)
    assert p["poisson_ratio"] == pytest.approx(0.3)
    assert p["material_params"]["plane_stress"] is False


def test_rule_parse_e_equals_gpa():
    p = rule_based_parse("cantilever under gravity with E = 70 GPa")
    assert p["young_modulus"] == pytest.approx(70e9)
    assert p["material_params"]["gravity"] is True


def test_rule_parse_thermal_conductivity_alias():
    p = rule_based_parse("rod with thermal conductivity of 0.5")
    assert p["diffusivity"] == pytest.approx(0.5)


# ----------------------------------------------------------------------
# Parser phrasing coverage, round 3 additions (reference prompt rules:
# composite-core defaults :273-311, IC parse order :335-348, source
# phrases :350-358, 3D dims :246, cylinder keywords :239)
# ----------------------------------------------------------------------

def test_rule_parse_zero_initial_condition():
    p = rule_based_parse("rod with zero initial condition, left end 100°C")
    assert p["initial_type"] == "zero"
    assert p["initial_value"] == 0.0


def test_rule_parse_cosine_beats_constant_and_wave_number():
    """Reference parse order: 'cosine' anywhere wins, even alongside
    'initial temperature'; 'wave number' must not flip pde_type to wave."""
    p = rule_based_parse("initial temperature is a cosine function with an "
                         "amplitude of 10 and wave number 2")
    assert p["pde_type"] == "heat"
    assert p["initial_type"] == "cosine"
    assert p["initial_amplitude"] == 10.0
    assert p["initial_wavenumber"] == 2.0


def test_rule_parse_internal_heat_generation():
    p = rule_based_parse("rod with internal heat generation of 50")
    assert p["source_type"] == "constant"
    assert p["source_value"] == 50.0


def test_rule_parse_heating_of():
    p = rule_based_parse("plate with heating of 25 applied")
    assert p["source_type"] == "constant"
    assert p["source_value"] == 25.0


def test_rule_parse_star_separated_three_dims():
    """'1m*0.2m*0.2' → all three extracted AND dim forced to 3 even though
    'plate' alone would have implied 2D (reference CRITICAL FOR 3D)."""
    p = rule_based_parse("elasticity of a plate 1m*0.2m*0.2 under gravity")
    assert p["dim"] == 3
    assert p["domain_size"] == {"Lx": 1.0, "Ly": pytest.approx(0.2),
                                "Lz": pytest.approx(0.2)}


def test_rule_parse_trailing_long_and_tall():
    p = rule_based_parse("a 2 m long steel bar under heat")
    assert p["domain_size"]["length"] == pytest.approx(2.0)
    p = rule_based_parse("a steel column 3 m tall and 0.2 m radius under heat")
    assert p["geometry_type"] == "cylinder"
    assert p["domain_size"]["h"] == pytest.approx(3.0)
    assert p["geometry_params"]["cylinder_radius"] == pytest.approx(0.2)


def test_rule_parse_wave_type_routes_to_wave_solver():
    """The reference parser emits pde_type='wave' but its dispatcher has no
    wave route (every wave query errors out).  Extension: the same query
    solves through the Newmark wave family (api.solve_wave_1D)."""
    p = rule_based_parse("wave in a string with wave speed 2")
    assert p["pde_type"] == "wave"
    assert p["wave_speed"] == 2.0
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(normalize_params_dict(p)))
    assert name == "solve_wave_1D"
    assert args["wave_speed"] == 2.0
    # default stepping covers two fundamental periods at 100 steps each
    assert args["num_steps"] == 200
    assert args["dt"] == pytest.approx(2.0 * 2.0 / 2.0 / 100.0)


def test_composite_circular_tunnel_high_conductivity():
    a = PDEParserAgent(llm=None)
    p = a.parse("heat in a circular tunnel with a heat conductor with "
                "high conductivity in the middle")
    assert p.geometry_type == "cylinder"
    assert p.core_diffusivity == pytest.approx(100.0)
    assert p.core_radius == pytest.approx(0.1)


def test_composite_insulator_low_default():
    a = PDEParserAgent(llm=None)
    p = a.parse("heat in a circular tunnel with an insulator in the middle")
    assert p.core_diffusivity == pytest.approx(0.01)


def test_composite_neutral_conductor_default():
    a = PDEParserAgent(llm=None)
    p = a.parse("cylindrical pipe with a conductor in the middle")
    assert p.core_diffusivity == pytest.approx(10.0)


def test_composite_core_radius_from_inner_bore():
    """Hollow cylinder + core: core fills the bore (core_radius = r1)."""
    a = PDEParserAgent(llm=None)
    p = a.parse("heat in a tube with inner radius 0.2 m and outer radius "
                "0.5 m, with a conductor in the middle")
    assert p.core_radius == pytest.approx(0.2)


def test_composite_core_radius_fraction_of_outer():
    a = PDEParserAgent(llm=None)
    p = a.parse("solid cylinder of radius 1 m with a conductor in the middle")
    assert p.core_radius == pytest.approx(0.3)


def test_composite_not_triggered_without_curvilinear_geometry():
    """'30 nm thick conductor' (a conductor as the object, Cartesian) must
    NOT sprout composite-core parameters."""
    a = PDEParserAgent(llm=None)
    p = a.parse("heat in a 30 nm thick conductor, 100 steps")
    assert p.core_diffusivity is None
    assert p.core_radius is None


# ---- round-4 NL battery: per-face BC lists, mixed units, shell phrasing,
# ---- directional body forces (VERDICT r3 item 7; reference prompt rules at
# ---- pde_parser_agent.py:313-314, 385-393, 424-429, 472)

def test_rule_parse_by_separator_mixed_units():
    """'2 m by 30 cm' — 'by' is a size separator with per-number units."""
    r = rule_based_parse("steel plate 2 m by 30 cm under plane stress")
    assert r["domain_size"] == {"Lx": 2.0, "Ly": pytest.approx(0.3)}
    assert r["dim"] == 2


def test_rule_parse_body_force_negative_z_direction():
    r = rule_based_parse(
        "elastic cube with a body force of 1000 N/m3 in the negative z "
        "direction")
    assert r["pde_type"] == "elasticity"
    assert r["material_params"]["body_fz"] == pytest.approx(-1000.0)
    assert "body_force" not in r["material_params"]


def test_rule_parse_body_force_positive_axis():
    r = rule_based_parse(
        "elastic box 1m x 0.2m x 0.2m with body force of 100 along the "
        "+x axis")
    assert r["material_params"]["body_fx"] == pytest.approx(100.0)
    assert r["domain_size"] == {"Lx": 1.0, "Ly": 0.2, "Lz": 0.2}


def test_rule_parse_downward_body_force_3d():
    r = rule_based_parse("3D elasticity with downward body force 500")
    assert r["material_params"]["body_fz"] == pytest.approx(-500.0)


def test_rule_parse_downward_body_force_2d_is_minus_y():
    r = rule_based_parse(
        "2D plate with a body force of 80 acting downward, plane stress")
    assert r["material_params"]["body_fy"] == pytest.approx(-80.0)


def test_rule_parse_body_force_tuple():
    r = rule_based_parse("2D plate with body force (0, -100)")
    assert r["pde_type"] == "elasticity"
    assert r["material_params"]["body_fx"] == pytest.approx(0.0)
    assert r["material_params"]["body_fy"] == pytest.approx(-100.0)


def test_rule_parse_body_force_keyword_implies_elasticity():
    r = rule_based_parse("bar with body force of 100 acting downward")
    assert r["pde_type"] == "elasticity"
    # 1D bar: scalar axial load, the solve_elasticity_1D_static contract
    assert r["material_params"]["body_force"] == pytest.approx(100.0)


def test_rule_parse_spherical_shell_thickness():
    """'shell of inner radius 5 cm and thickness 2 cm' — thickness implies
    the outer radius without the word 'wall'."""
    r = rule_based_parse("spherical shell of inner radius 5 cm and "
                         "thickness 2 cm, outer surface at 0 C")
    assert r["geometry_type"] == "sphere"
    gp = r["geometry_params"]
    assert gp["r_inner"] == pytest.approx(0.05)
    assert gp["r_outer"] == pytest.approx(0.07)
    assert r["bc_values"]["T_outer"] == pytest.approx(0.0)


def test_rule_parse_cylinder_bare_height():
    """comma-list phrasing: 'height 2m' with no of/=/: still parses."""
    r = rule_based_parse("hollow cylinder with inner radius 0.2m, outer "
                         "radius 0.5m, height 2m")
    assert r["domain_size"]["h"] == pytest.approx(2.0)
    assert r["geometry_params"] == {"r_inner": 0.2, "r_outer": 0.5}


def test_rule_parse_both_ends_fixity_warns_in_notes():
    """The 1D bar tool is fixed-free (frozen reference contract); asking for
    both ends clamped must surface the mismatch, not silently ignore it."""
    r = rule_based_parse("elastic bar fixed at both ends with body force 10")
    assert any("fixed-free" in n for n in r.get("notes", []))
    assert r["material_params"]["body_force"] == pytest.approx(10.0)


def test_rule_parse_clamped_implies_elasticity_with_gravity():
    r = rule_based_parse("beam clamped at the left face under gravity")
    assert r["pde_type"] == "elasticity"
    assert r["material_params"]["gravity"] is True


def test_full_shape_query_is_not_followup():
    """r4 CLI battery bug: a complete query naming its own curvilinear
    geometry inherited pde_type=elasticity from a stale context because
    cylinder/sphere/radius were missing from the geometry keywords."""
    from pde_solver.agents.orchestrator import MultiAgentOrchestrator
    o = MultiAgentOrchestrator()
    o.memory.record_simulation({"pde_type": "elasticity", "dim": 3})
    assert not o._is_followup_question(
        "steady heat in a hollow cylinder, inner radius 0.1 m, outer "
        "radius 0.5 m, inner wall at 300 C, outer wall at 20 C")
    assert not o._is_followup_question(
        "simulate heat in a sphere of radius 0.5 m, surface at 0 C, "
        "initial temperature 100 C, for 5 seconds")
    # a genuine follow-up stays a follow-up
    assert o._is_followup_question("change the source to 50")


def test_followup_merge_switches_back_to_heat():
    """Explicit 'heat' in a follow-up must override a previous elasticity
    pde_type (the merge previously only switched AWAY from heat)."""
    from pde_solver.agents.orchestrator import MultiAgentOrchestrator
    from pde_solver.schema import PDEParameters
    o = MultiAgentOrchestrator()
    prev = {"pde_type": "elasticity", "dim": 2,
            "domain_size": {"Lx": 1.0, "Ly": 1.0}}
    new = PDEParameters(pde_type="heat", dim=2)
    merged = o._merge_parameters(prev, new,
                                 "now simulate heat instead with the same "
                                 "plate")
    assert merged.pde_type == "heat"


def test_rule_parse_change_to_value_connector():
    """Reference README follow-up: "Change Young's modulus to 70 GPa" — the
    'to' connector was missing from every material-parameter pattern, so
    follow-up changes were silently ignored (r4 CLI battery)."""
    r = rule_based_parse("change young's modulus to 70 GPa")
    assert r["young_modulus"] == pytest.approx(70e9)
    r = rule_based_parse("set the diffusivity to 2.5")
    assert r["diffusivity"] == pytest.approx(2.5)
    r = rule_based_parse("change the source to 50")
    assert r["source_value"] == pytest.approx(50.0)
    r = rule_based_parse("change poisson's ratio to 0.25")
    assert r["poisson_ratio"] == pytest.approx(0.25)
    r = rule_based_parse("set the time step to 0.005")
    assert r["dt"] == pytest.approx(0.005)


def test_rule_parse_mm_units_not_meters():
    """r4 CLI battery bug: '(m|cm|mm)' alternation matched the bare 'm'
    against the first letter of 'mm', so '200 mm' parsed as 200 METERS.
    Every unit group now lists longest-first with a word boundary."""
    r = rule_based_parse("heat in a rod 200 mm long, left end at 100 C")
    assert r["domain_size"]["length"] == pytest.approx(0.2)
    r = rule_based_parse("cylinder with radius 50 mm and height 300 mm")
    assert r["geometry_params"]["cylinder_radius"] == pytest.approx(0.05)
    assert r["domain_size"]["h"] == pytest.approx(0.3)
    r = rule_based_parse("plate 500 mm x 200 mm at 20 C")
    assert r["domain_size"]["Lx"] == pytest.approx(0.5)
    assert r["domain_size"]["Ly"] == pytest.approx(0.2)
    r = rule_based_parse("sphere with a wall thickness of 5 mm and outer "
                         "radius 10 cm")
    assert r["geometry_params"]["r_outer"] == pytest.approx(0.10)
    assert r["geometry_params"]["r_inner"] == pytest.approx(0.095)


def test_rule_parse_gravity_without_thermal_cue_is_elasticity():
    """'a steel beam under gravity' names no heat/elasticity word at all —
    gravity/load phrasing only ever appears in the reference prompt's
    elasticity examples (pde_parser_agent.py:385-395)."""
    r = rule_based_parse("a steel beam 2 m long under gravity, fixed at "
                         "the left face")
    assert r["pde_type"] == "elasticity"
    assert r["material_params"]["gravity"] is True
    # the word 'loaded' alone also routes to elasticity
    r = rule_based_parse("a plate loaded by its own weight")
    assert r["pde_type"] == "elasticity"
    # ...but any thermal cue keeps heat routing
    r = rule_based_parse("temperature of a plate under gravity heated "
                         "from the left")
    assert r["pde_type"] == "heat"


def test_rule_parse_length_width_height_folds_to_box():
    """'2 m long, 0.3 m wide, 0.1 m tall' is a 3-D box (reference beam
    phrasing), not a 1-D rod plus a stray cylinder height."""
    r = rule_based_parse("steel beam 2 m long, 0.3 m wide and 0.1 m tall "
                         "under gravity")
    assert r["dim"] == 3
    assert r["domain_size"] == {"Lx": 2.0, "Ly": 0.3, "Lz": 0.1}
    # length + width only → 2-D
    r = rule_based_parse("plate 1 m long and 40 cm wide at 0 C")
    assert r["dim"] == 2
    assert r["domain_size"] == {"Lx": 1.0, "Ly": 0.4}
    # 'width of X' phrasing
    r = rule_based_parse("a slab with length of 2 m and width of 50 cm")
    assert r["domain_size"] == {"Lx": 2.0, "Ly": 0.5}


def test_rule_parse_cube_sides():
    """'a cube with 30 cm sides' → equal box extents, dim 3."""
    r = rule_based_parse("heat in a cube with 30 cm sides, faces at 0 C")
    assert r["dim"] == 3
    assert r["domain_size"] == {"Lx": 0.3, "Ly": 0.3, "Lz": 0.3}
    r = rule_based_parse("a box with sides of 0.5 m, initially 100 C")
    assert r["domain_size"] == {"Lx": 0.5, "Ly": 0.5, "Lz": 0.5}


def test_followup_merge_switches_to_elasticity_on_cue_words():
    """A self-contained elasticity query classified as a follow-up ('and'/
    'with' triggers the reference's keyword list) must still switch the
    pde_type: the parser's elasticity cues (gravity/clamped/beam...) count
    as the explicit mention, not just the literal word 'elasticity'."""
    from pde_solver.agents.orchestrator import MultiAgentOrchestrator
    from pde_solver.schema import PDEParameters
    o = MultiAgentOrchestrator()
    prev = {"pde_type": "heat", "dim": 1, "domain_size": {"length": 0.2}}
    new = PDEParameters(pde_type="elasticity", dim=3,
                        domain_size={"Lx": 2.0, "Ly": 0.3, "Lz": 0.1},
                        material_params={"gravity": True})
    merged = o._merge_parameters(
        prev, new, "a steel beam 2 m long, 0.3 m wide and 0.1 m tall "
        "under gravity, fixed at the left face")
    assert merged.pde_type == "elasticity"
    assert merged.dim == 3
    # ...but a genuine heat follow-up with no elasticity cue keeps heat
    new2 = PDEParameters(pde_type="heat", dim=1)
    merged2 = o._merge_parameters(prev, new2, "change the source to 50")
    assert merged2.pde_type == "heat"


def test_rule_parse_solid_cylinder_with_height_is_3d():
    """Reference cylindrical-3D rule (pde_parser_agent.py:247-254): radius
    + height on a solid cylinder → dim 3, routed to solve_heat_3D with the
    height as the axial extent; hollow annuli keep the 1D radial route."""
    d = DispatcherAgent()
    p = PDEParameters.from_dict(normalize_params_dict(rule_based_parse(
        "transient heat in a steel cylinder of radius 10 cm and height "
        "50 cm, surface at 200 C, initially 20 C")))
    assert p.dim == 3
    name, args = d.route(p)
    assert name == "solve_heat_3D"
    assert args["Lx"] == pytest.approx(0.5)         # height → axial extent
    assert args["cylinder_radius"] == pytest.approx(0.1)
    assert args["T_boundary"] == 200.0 and args["T_initial"] == 20.0
    # "3 m tall column of diameter 0.6 m" — same rule via tall/diameter
    p2 = PDEParameters.from_dict(normalize_params_dict(rule_based_parse(
        "thermal analysis of a 3 m tall concrete column of diameter "
        "0.6 m, surface at 35 C")))
    name2, args2 = d.route(p2)
    assert name2 == "solve_heat_3D" and args2["Lx"] == pytest.approx(3.0)
    assert args2["cylinder_radius"] == pytest.approx(0.3)
    # hollow cylinder with height stays radial (the reference's 3D tool is
    # solid-only; the 1D annulus solves the actual hollow profile)
    p3 = PDEParameters.from_dict(normalize_params_dict(rule_based_parse(
        "hollow cylinder with inner radius 0.2m, outer radius 0.5m, "
        "height 2m")))
    assert d.route(p3)[0] == "solve_heat_1D_cylindrical"


def test_rule_parse_axisymmetric_is_2d():
    p = PDEParameters.from_dict(normalize_params_dict(rule_based_parse(
        "axisymmetric heat flow in a pipe, inner radius 2 cm, outer "
        "radius 5 cm, length 1 m")))
    assert p.dim == 2
    d = DispatcherAgent()
    name, args = d.route(p)
    assert name == "solve_heat_2D_cylindrical"
    assert args["r_inner"] == pytest.approx(0.02)
    assert args["r_outer"] == pytest.approx(0.05)
    assert args["z_length"] == pytest.approx(1.0)


def test_composite_keyword_query_routes_to_3d_core():
    """The reference's composite examples all emit dim=3 → solve_heat_3D
    (pde_parser_agent.py:674-681); a radial route would silently drop the
    core (the 1D cylindrical tool has no core parameters)."""
    a = PDEParserAgent(llm=None)
    d = DispatcherAgent()
    p = a.parse("heat in a circular tunnel with a heat conductor with "
                "high conductivity in the middle")
    assert p.dim == 3
    name, args = d.route(p)
    assert name == "solve_heat_3D"
    assert args["core_diffusivity"] == pytest.approx(100.0)
    # explicit values: "core of radius 5 cm ... core conductivity 400"
    p2 = a.parse("composite cylinder with a copper core of radius 5 cm "
                 "inside a 20 cm radius steel cylinder, core "
                 "conductivity 400")
    name2, args2 = d.route(p2)
    assert name2 == "solve_heat_3D"
    assert args2["core_radius"] == pytest.approx(0.05)
    assert args2["core_diffusivity"] == pytest.approx(400.0)
    assert args2["cylinder_radius"] == pytest.approx(0.2)
    # explicit 1D phrasing keeps the radial route
    p3 = a.parse("1D radial heat in a circular tunnel with an insulator "
                 "in the middle")
    assert d.route(p3)[0] == "solve_heat_1D_cylindrical"


def test_rule_parse_inside_outside_and_quench():
    r = rule_based_parse("heat conduction in a concrete wall, inside at "
                         "25 C, outside at -5 C")
    assert r["bc_values"] == {"T_left": 25.0, "T_right": -5.0}
    r = rule_based_parse("hollow cylinder, inside at 300 C, outside at "
                         "30 C")
    assert r["bc_values"] == {"T_inner": 300.0, "T_outer": 30.0}
    r = rule_based_parse("temperature history of a sphere of diameter "
                         "10 cm quenched from 800 C to 20 C water")
    assert r["initial_value"] == 800.0
    assert r["bc_values"]["T_outer"] == 20.0
    assert r["geometry_params"]["sphere_radius"] == pytest.approx(0.05)


def test_rule_parse_square_sides_and_bare_poisson():
    r = rule_based_parse("2D heat in a 50 cm square plate, boundary at 0 C")
    assert r["domain_size"] == {"Lx": 0.5, "Ly": 0.5}
    r = rule_based_parse("plane strain deformation of a dam cross-section "
                         "10 m by 30 m, E 30 GPa, poisson 0.2")
    assert r["poisson_ratio"] == pytest.approx(0.2)
    assert r["material_params"]["plane_stress"] is False


def test_rule_parse_wave_speed_overrides_vibration_elasticity():
    """'vibrating membrane with wave speed 5' is the scalar wave equation;
    vibration phrasing WITH elastic material data stays elastodynamics."""
    r = rule_based_parse("simulate a vibrating membrane 1 m by 1 m with "
                         "wave speed 5")
    assert r["pde_type"] == "wave" and r["dim"] == 2
    r = rule_based_parse("a vibrating steel beam 1 m x 0.1 m x 0.1 m, "
                         "density 7800, E 200 GPa")
    assert r["pde_type"] == "elasticity"


# ----------------------------------------------------------------------
# Mixed (Robin/Neumann/insulated) BC extraction + routing — extension
# beyond the reference's Dirichlet-only heat tools
# ----------------------------------------------------------------------

def test_rule_parse_convection_right_face():
    r = rule_based_parse(
        "1D heat in a 2 m rod, left end held at 100°C, the right end is "
        "cooled by convection to 25°C air with heat transfer coefficient 15")
    assert r["bc_type"] == "mixed"
    assert r["bc_values"]["T_left"] == 100.0
    spec = r["bc_values"]["right"]
    assert spec == {"type": "robin", "h": 15.0, "T_ambient": 25.0}


def test_rule_parse_convection_defaults_noted():
    r = rule_based_parse("a 1 m rod at 80°C initially, the right face "
                         "convects to the surroundings")
    spec = r["bc_values"]["right"]
    assert spec["type"] == "robin" and spec["h"] == 10.0
    assert any("heat-transfer coefficient" in n for n in r["notes"])


def test_rule_parse_insulated_sides_and_flux():
    r = rule_based_parse(
        "3D heat in a 1m x 0.2m x 0.2m bar, heat flux of 500 W/m2 into the "
        "left face, right face at 20°C, all other faces insulated")
    assert r["bc_values"]["left"] == {"type": "neumann", "flux": 500.0}
    assert r["bc_values"]["sides"] == {"type": "insulated"}
    assert r["bc_values"]["T_right"] == 20.0


def test_rule_parse_flux_removed_is_negative():
    r = rule_based_parse(
        "2D plate with a heat flux of 200 W/m2 removed from the top edge")
    assert r["bc_values"]["top"]["flux"] == -200.0


def test_mixed_routing_and_args():
    d = DispatcherAgent()
    p = PDEParameters(
        pde_type="heat", dim=1, bc_type="mixed",
        domain_size={"length": 2.0},
        bc_values={"T_left": 100.0,
                   "right": {"type": "robin", "h": 15.0, "T_ambient": 25.0}},
        steady=True)
    name, args = d.route(p)
    assert name == "solve_heat_1D_mixed"
    assert args["boundary_conditions"]["left"] == {
        "type": "dirichlet", "value": 100.0}
    assert args["boundary_conditions"]["right"]["h"] == 15.0
    assert "T_left" not in args and "T_right" not in args

    # pure-Dirichlet queries keep the reference route
    p2 = PDEParameters(pde_type="heat", dim=1,
                       bc_values={"T_left": 20.0, "T_right": 0.0})
    assert d.route(p2)[0] == "solve_heat_1D"

    # 3D mixed: boundary spec replaces directional keys
    p3 = PDEParameters(
        pde_type="heat", dim=3, bc_type="mixed",
        bc_values={"left": {"type": "neumann", "flux": 500.0},
                   "T_right": 20.0,
                   "sides": {"type": "insulated"}},
        steady=True)
    name3, args3 = d.route(p3)
    assert name3 == "solve_heat_3D_mixed"
    bc3 = args3["boundary_conditions"]
    assert bc3["right"] == {"type": "dirichlet", "value": 20.0}
    # the "sides" group expands to the four concrete non-x faces
    for face in ("front", "back", "bottom", "top"):
        assert bc3[face] == {"type": "insulated"}
    assert "T_boundary" not in args3 and "geometry_type" not in args3


def test_mixed_nl_end_to_end():
    """NL convection query through parser → dispatcher → solver → artifact."""
    from pde_solver.agents.dispatcher_agent import LocalToolSet

    a = PDEParserAgent()
    d = DispatcherAgent()
    p = a.parse("steady 1D heat in a 1 m rod with diffusivity 1, left end "
                "at 100°C, right end cooled by convection to 0°C air with "
                "heat transfer coefficient 1")
    name, args = d.route(p)
    assert name == "solve_heat_1D_mixed"
    res = run(d.dispatch(p))
    assert "error" not in res or not res.get("error")


def test_rule_parse_quench_with_h_is_robin():
    r = rule_based_parse(
        "temperature history of a steel sphere of diameter 10 cm quenched "
        "from 800 C to 20 C water with h = 500")
    assert r["bc_values"]["all"] == {"type": "robin", "h": 500.0,
                                     "T_ambient": 20.0}
    assert r["initial_value"] == 800.0
    # the Dirichlet fallback from the quench rule is still present; the
    # dispatcher's typed-spec precedence resolves the outer face to Robin
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(
        {k: v for k, v in r.items()}))
    assert name == "solve_heat_radial_mixed"
    assert args["kind"] == "sphere"
    bc = args["boundary_conditions"]
    # "all" expands to concrete faces; the typed spec beat the quench
    # rule's T_outer=20 Dirichlet on the same physical face
    assert bc["outer"]["type"] == "robin"
    assert "all" not in bc


def test_rule_parse_quench_without_h_stays_dirichlet():
    r = rule_based_parse(
        "a sphere of diameter 10 cm quenched from 800 C to 20 C water")
    assert r["bc_values"].get("T_outer") == 20.0
    assert not any(isinstance(v, dict) for v in r["bc_values"].values())
    d = DispatcherAgent()
    assert d.route(PDEParameters.from_dict(r))[0] == "solve_heat_1D_spherical"


def test_radial_mixed_routing_annulus_convective_outer():
    d = DispatcherAgent()
    p = PDEParameters(
        pde_type="heat", dim=1, geometry_type="cylinder",
        geometry_params={"r_inner": 0.1, "r_outer": 0.5},
        bc_values={"T_inner": 300.0,
                   "outer": {"type": "robin", "h": 12.0, "T_ambient": 30.0}},
        steady=True)
    name, args = d.route(p)
    assert name == "solve_heat_radial_mixed"
    assert args["kind"] == "cylinder"
    assert args["r_inner"] == 0.1 and args["r_outer"] == 0.5
    bc = args["boundary_conditions"]
    assert bc["inner"] == {"type": "dirichlet", "value": 300.0}
    assert bc["outer"]["h"] == 12.0
    assert "T_inner" not in args and "T_outer" not in args


def test_followup_updates_robin_coefficient_and_ambient(orch):
    run(orch.solve("steady 1D heat in a 1 m rod, left end at 100 C, right "
                   "end cooled by convection to 25 C air with heat transfer "
                   "coefficient 15"))
    r2 = run(orch.solve("change the heat transfer coefficient to 50"))
    bc = r2["pde_params"]["bc_values"]
    assert bc["right"]["h"] == 50.0 and bc["right"]["T_ambient"] == 25.0
    assert "_robin_update" not in bc
    r3 = run(orch.solve("set the ambient temperature to 40 C"))
    bc = r3["pde_params"]["bc_values"]
    assert bc["right"]["h"] == 50.0 and bc["right"]["T_ambient"] == 40.0


# ----------------------------------------------------------------------
# Surface loads (end load / traction / pressure) — elasticity extension
# ----------------------------------------------------------------------

def test_rule_parse_tip_load_cantilever():
    r = rule_based_parse(
        "a 2 m x 0.2 m steel cantilever, E 200 GPa, with a downward tip "
        "load of 1 kN at the free end")
    assert r["pde_type"] == "elasticity"
    spec = r["bc_values"]["right"]
    assert spec["type"] == "force" and spec["vector"][-1] == -1000.0
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_2D_loaded"
    assert args["loads"]["right"]["vector"][-1] == -1000.0


def test_rule_parse_axial_bar_end_load():
    r = rule_based_parse(
        "a 1D steel bar 1.5 m long, cross-sectional area 0.01, with a "
        "tensile force of 5 kN applied at the free end")
    assert r["pde_type"] == "elasticity" and r["dim"] == 1
    assert r["bc_values"]["right"] == {"type": "force_axial", "value": 5000.0}
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_1D_loaded"
    assert args["end_load"] == 5000.0 and args["area"] == 0.01


def test_rule_parse_pressure_on_top():
    r = rule_based_parse(
        "plane strain analysis of a 4 m x 1 m concrete slab, E 30 GPa, "
        "with a pressure of 2 MPa on the top face")
    spec = r["bc_values"]["top"]
    assert spec == {"type": "pressure", "value": 2.0e6}
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_2D_loaded"
    assert args["plane_stress"] is False


def test_loaded_nl_end_to_end():
    a = PDEParserAgent()
    d = DispatcherAgent()
    p = a.parse("a steel bar 1 m long, area 0.02, E 200 GPa, with a "
                "tensile force of 10 kN at the free end")
    name, args = d.route(p)
    assert name == "solve_elasticity_1D_loaded"
    res = run(d.dispatch(p))
    assert not res.get("error")
    # sigma = P/A = 10e3/0.02 = 5e5 Pa, constant along the bar
    from pde_solver.fields import load_field
    f = load_field(res["data_file"])
    np.testing.assert_allclose(f.values_array()[0], 5.0e5, rtol=1e-6)


def test_rule_parse_convection_battery_round6():
    # "all sides" is the whole boundary, not just the lateral faces
    r = rule_based_parse(
        "steel plate exposed to air on all sides, h = 12, ambient 22 C")
    assert r["bc_values"]["all"] == {"type": "robin", "h": 12.0,
                                     "T_ambient": 22.0}
    # bare "h 300 W/m2K": the unit disambiguates from cylinder height;
    # "cooled in oil at 50 C" supplies the bath temperature
    r = rule_based_parse("sphere cooled in oil at 50 C with h 300 W/m2K")
    assert r["bc_values"]["all"] == {"type": "robin", "h": 300.0,
                                     "T_ambient": 50.0}
    # "brick wall" must NOT be parsed as a face word; inside/outside map
    # to the wall's two faces
    r = rule_based_parse("brick wall, outside exposed to cold air at -10 C "
                         "with heat transfer coefficient 25, inside at 20 C")
    assert r["bc_values"]["outer"] == {"type": "robin", "h": 25.0,
                                       "T_ambient": -10.0}
    assert r["bc_values"]["T_left"] == 20.0
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    # "brick" in "brick wall" is a MATERIAL modifier, not the box shape
    # (r5 battery-24) — the wall solves through-thickness 1D, inside/
    # outside mapping to its two faces
    assert name == "solve_heat_1D_mixed"
    bc = args["boundary_conditions"]
    # "outer" resolves to the x-high face inside the solver (_FACE_ALIASES)
    assert bc["outer"]["type"] == "robin" and bc["left"]["value"] == 20.0
    # kW/m2 flux scaling
    r = rule_based_parse(
        "heat flux of 1 kW/m2 applied to the bottom of a steel plate")
    assert r["bc_values"]["bottom"]["flux"] == 1000.0


def test_poisson_routes_to_steady_heat():
    r = rule_based_parse(
        "solve the Poisson equation on a 1 m x 1 m plate with a source of "
        "5 and boundary at 0")
    assert r["pde_type"] == "poisson" and r["steady"] is True
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_heat_2D"
    assert args["steady"] is True and args["source_value"] == 5.0
    res = run(d.dispatch(PDEParameters.from_dict(r)))
    assert not res.get("error")


def test_rule_parse_number_first_force_and_area_units():
    r = rule_based_parse(
        "steel rod 1 m long stretched by a 20 kN tensile force, area 5 cm2")
    assert r["bc_values"]["right"] == {"type": "force_axial",
                                       "value": 20000.0}
    assert r["material_params"]["area"] == pytest.approx(5e-4)
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_1D_loaded"
    assert args["end_load"] == 20000.0 and args["area"] == pytest.approx(5e-4)
    # bare "3 forces" must NOT match (unit required in number-first form)
    r2 = rule_based_parse("an elastic beam subject to 3 forces")
    assert not any(isinstance(v, dict) and v.get("type", "").startswith("force")
                   for v in (r2.get("bc_values") or {}).values())


def test_geometry_switch_followup_resets_stale_bcs(orch):
    """A 'with'-keyword query is follow-up-classified, but a geometry
    switch means a new problem: the slab's flux/Dirichlet faces must not
    leak onto the sphere, and the bare 'h = N' follow-up must patch the
    convective spec."""
    run(orch.solve("steady heat conduction through a 20 cm concrete slab "
                   "with a heat flux of 100 W/m2 entering the left face "
                   "and the right face held at 5 C"))
    r2 = run(orch.solve("how hot does a 1 cm steel sphere get when "
                        "quenched from 900 C into 25 C oil with h = 400?"))
    bc = r2["pde_params"]["bc_values"]
    assert bc == {"all": {"type": "robin", "h": 400.0, "T_ambient": 25.0}}
    assert r2["pde_params"]["geometry_type"] == "sphere"
    r3 = run(orch.solve("now use h = 1000"))
    assert r3["pde_params"]["bc_values"]["all"]["h"] == 1000.0
    assert not (r3.get("dispatch_result") or {}).get("error")


def test_rule_parse_battery_round9():
    d = DispatcherAgent()
    # a rod WITH a radius is a cylinder; "generating X W/m3" is a source
    r = rule_based_parse(
        "steady temperature profile of a nuclear fuel rod 1 cm radius "
        "generating 5e7 W/m3, surface held at 300 C")
    assert r["geometry_type"] == "cylinder"
    assert r["source_value"] == 5e7
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_heat_1D_cylindrical"
    assert args["r_outer"] == pytest.approx(0.01)
    assert args["T_outer"] == 300.0
    # "cools in a 30 C furnace" is convection with number-first ambient
    r2 = rule_based_parse(
        "a steel block 10 cm cube initially at 800 C cools in a 30 C "
        "furnace, h = 25")
    spec = r2["bc_values"]["all"]
    assert spec["h"] == 25.0 and spec["T_ambient"] == 30.0
    # number-first pressure phrasing
    r3 = rule_based_parse(
        "displacement of a rubber sheet 50 cm x 50 cm under 1 kPa "
        "pressure, E 0.1 GPa, plane stress")
    assert r3["bc_values"]["top"] == {"type": "pressure", "value": 1000.0}
    name3, args3 = d.route(PDEParameters.from_dict(r3))
    assert name3 == "solve_elasticity_2D_loaded"
    # elastic bars with a radius keep their 1D axial route
    r4 = rule_based_parse("a steel bar of radius 1 cm under a tensile "
                          "force of 5 kN")
    assert r4.get("geometry_type") != "cylinder"


def test_rule_parse_battery_round10():
    d = DispatcherAgent()
    # bare "load" cues elasticity (the old \bloaded?\b regex required
    # 'loade' and silently never matched 'load')
    r = rule_based_parse("a 1.5 m long aluminum column with 10 cm diameter "
                         "carrying 500 kN compressive load, area 0.00785")
    assert r["pde_type"] == "elasticity"
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_1D_loaded"
    assert args["end_load"] == -500000.0  # compressive
    # singular-face Dirichlet + typed specs: bottom stays Dirichlet while
    # the "other faces" insulated group expands around it
    r2 = rule_based_parse(
        "steady state temperature of a chip dissipating 50 W/cm3 in a "
        "1 cm x 1 cm x 0.1 cm die, bottom at 25 C, other faces insulated")
    assert r2["source_value"] == pytest.approx(5e7)  # W/cm3 -> W/m3
    name2, args2 = d.route(PDEParameters.from_dict(r2))
    assert name2 == "solve_heat_3D_mixed"
    bc = args2["boundary_conditions"]
    assert bc["bottom"] == {"type": "dirichlet", "value": 25.0}
    assert bc["top"] == {"type": "insulated"}
    # reference parity: bottom-only Dirichlet WITHOUT typed specs keeps
    # the uniform-boundary rule and the reference tool
    r3 = rule_based_parse("2D heat in a 50 cm square plate, bottom at 0 C")
    assert r3["bc_values"] == {"T_boundary": 0.0}
    assert d.route(PDEParameters.from_dict(r3))[0] == "solve_heat_2D"


def test_rule_parse_battery_round11():
    d = DispatcherAgent()
    # dual-fluid pipe: inner Dirichlet (hot water), outer convective (air
    # named with temperature + film coefficient right after)
    r = rule_based_parse(
        "cooling of a hot water pipe: inner radius 1 cm, outer radius "
        "1.2 cm, water at 80 C inside, air at 20 C outside with h = 6")
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_heat_radial_mixed"
    bc = args["boundary_conditions"]
    assert bc["inner"] == {"type": "dirichlet", "value": 80.0}
    assert bc["outer"] == {"type": "robin", "h": 6.0, "T_ambient": 20.0}
    # "pressure vessel" with temperature data is a HEAT problem (the
    # pressure cue must not beat the NUM-°C thermal cue)
    r2 = rule_based_parse(
        "pressure vessel wall: sphere inner radius 0.5 m outer radius "
        "0.6 m, inside 300 C, outside 50 C, steady")
    assert r2["pde_type"] == "heat"
    assert d.route(PDEParameters.from_dict(r2))[0] == "solve_heat_1D_spherical"
    # mathematical notation
    r3 = rule_based_parse(
        "1D heat equation du/dt = 0.5 d2u/dx2 on [0, 2] with u(0)=1, "
        "u(2)=0")
    assert r3["diffusivity"] == 0.5
    assert r3["bc_values"] == {"T_left": 1.0, "T_right": 0.0}
    assert r3["domain_size"]["length"] == 2.0
    # bare power-density flux with face + "stays at" Dirichlet connector
    r4 = rule_based_parse(
        "heat a 2 m rod from the left with 1000 W/m2 while the right end "
        "stays at 20 C, conductivity 50")
    assert r4["bc_values"]["left"] == {"type": "neumann", "flux": 1000.0}
    assert r4["bc_values"]["T_right"] == 20.0
    assert r4["diffusivity"] == 50.0
    # W/m2K must NOT parse as a flux (film-coefficient unit)
    r5 = rule_based_parse("plate cooled by convection with h of 40 W/m2K "
                          "to 20 C air")
    assert not any(isinstance(v, dict) and v.get("type") == "neumann"
                   for v in (r5.get("bc_values") or {}).values())


def test_rule_parse_battery_round12():
    d = DispatcherAgent()
    # smoke/dispersion cues advection; "air moving at 0.5 m/s" is velocity
    r = rule_based_parse("smoke dispersing in a 10 m corridor, air moving "
                         "at 0.5 m/s, diffusivity 0.1")
    assert r["pde_type"] == "advection"
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_advection_1D" and args["velocity"] == 0.5
    # number-first volumetric source with explicit unit
    r2 = rule_based_parse("a 1 m bar heated by a 5000 W/m3 source, "
                          "ends insulated")
    assert r2["source_value"] == 5000.0
    # a sideways load on a 1D member is bending: dim upgrades to the 2D
    # cantilever and the tip force points transverse
    r3 = rule_based_parse("how much does a 3 m steel flagpole bend under "
                          "a 300 N sideways force at the tip?")
    assert r3["pde_type"] == "elasticity" and r3["dim"] == 2
    name3, args3 = d.route(PDEParameters.from_dict(r3))
    assert name3 == "solve_elasticity_2D_loaded"
    assert args3["loads"]["right"]["vector"] == [0.0, -300.0]


def test_keyless_validation_screen_and_unsupported_physics(orch):
    # keyless mode: a query with zero physics vocabulary is rejected
    # instead of being "solved" as the default problem
    r = run(orch.solve("what's the weather like?"))
    assert r.get("status") == "not_pde"
    # honestly-unsupported physics reaches the clean error envelope
    r2 = run(orch.solve("solve navier-stokes flow past a cylinder at "
                        "Re 1000"))
    err = r2.get("error") or (r2.get("dispatch_result") or {}).get("error")
    assert err and "other" in err
    # plain PDE asks still go through
    r3 = run(orch.solve("solve the heat equation"))
    assert r3.get("html_path")


# ---- round-5 NL battery 14: copula verb chains, sentence-scoped insulated
# windows, immersion cues, named-unit durations, radius-interposed temps ----

def test_rule_parse_battery_round14_plate_mixed_bc():
    """'is held at' / 'is kept at' verb chains + the insulated matcher must
    not cross the sentence boundary (it insulated 'right' and dropped both
    Dirichlet edges)."""
    r = rule_based_parse(
        "We have an aluminum plate, 50 cm by 30 cm. The left edge is held "
        "at 150°C while the right edge is kept at 25°C. The top and bottom "
        "edges are insulated. What is the steady temperature field?")
    bc = r["bc_values"]
    assert bc["T_left"] == 150.0 and bc["T_right"] == 25.0
    assert bc["top"] == {"type": "insulated"}
    assert bc["bottom"] == {"type": "insulated"}
    assert "right" not in bc and "left" not in bc
    assert r["steady"] is True and r["dim"] == 2
    assert r["domain_size"] == {"Lx": 0.5, "Ly": 0.3}


def test_rule_parse_battery_round14_raised_to_and_initially():
    r = rule_based_parse(
        "A copper wire 1.5 m long is initially at 20°C. At t=0 both ends "
        "are raised to 80°C. Simulate the temperature evolution for 60 "
        "seconds.")
    assert r["bc_values"]["T_left"] == 80.0
    assert r["bc_values"]["T_right"] == 80.0
    assert r["initial_value"] == 20.0 and r["initial_type"] == "constant"
    assert r["total_time"] == 60.0


def test_rule_parse_battery_round14_starts_at_and_first_hour():
    r = rule_based_parse(
        "A 1 m x 1 m x 1 m granite block starts at 500°C and cools in "
        "20°C air with a heat transfer coefficient of 12. Show the first "
        "hour.")
    assert r["initial_value"] == 500.0
    assert r["bc_values"]["all"] == {"type": "robin", "h": 12.0,
                                     "T_ambient": 20.0}
    assert r["total_time"] == 3600.0


def test_rule_parse_battery_round14_duration_units():
    assert rule_based_parse("heat a 1 m rod for 10 minutes")["total_time"] \
        == 600.0
    assert rule_based_parse("simulate a 1 m rod over 2 hours")["total_time"] \
        == 7200.0
    # step counts must not be eaten by the duration rule
    r = rule_based_parse("run 100 steps of heat diffusion in a 1 m rod")
    assert r.get("num_steps") == 100 and r.get("total_time") is None


def test_rule_parse_battery_round14_furnace_immersion():
    """Medium-temperature-first immersion ('in a 700°C furnace') is a
    convection cue; 'h = 150' on a sphere is a film coefficient, never a
    150 m cylinder height."""
    r = rule_based_parse(
        "What's the temperature at the center of a 20 cm steel sphere "
        "after 2 minutes in a 700°C furnace, starting from 25°C, h = 150?")
    assert r["bc_values"]["all"] == {"type": "robin", "h": 150.0,
                                     "T_ambient": 700.0}
    assert r["initial_value"] == 25.0
    assert r["total_time"] == 120.0
    assert "h" not in (r.get("domain_size") or {})
    assert "_robin_update" not in r["bc_values"]


def test_rule_parse_battery_round14_hollow_sphere_radius_interposed():
    """'inner radius 2 cm at 300°C' — the radius clause sits between the
    face word and its temperature; backtracking must not split 'radius 10'
    into T_outer=0."""
    r = rule_based_parse(
        "Steady heat in a hollow sphere, inner radius 2 cm at 300°C, and "
        "the outer surface at radius 10 cm loses heat by convection with "
        "h = 25 W/m²K to 20°C air.")
    bc = r["bc_values"]
    assert bc["T_inner"] == 300.0
    assert "T_outer" not in bc
    assert bc["outer"] == {"type": "robin", "h": 25.0, "T_ambient": 20.0}
    assert r["geometry_params"]["r_inner"] == 0.02
    assert r["geometry_params"]["sphere_radius"] == 0.1


def test_rule_parse_battery_round14_cylinder_height_h_unchanged():
    """In a cylinder context a bare 'h = 2 m' stays the HEIGHT and must not
    double as a film coefficient."""
    r = rule_based_parse("cylinder radius 0.5 m and h = 2 m, "
                         "surface at 100 C")
    assert r["domain_size"]["h"] == 2.0
    assert "_robin_update" not in (r.get("bc_values") or {})


def test_orchestrator_fresh_standalone_h_becomes_robin(orch):
    """A FRESH query whose only convection evidence is a film coefficient
    must not leak the parser's _robin_update carrier downstream."""
    r = run(orch.solve("cool a 10 cm steel sphere from 300°C with a heat "
                       "transfer coefficient of 40 for 10 minutes"))
    bc = (r.get("pde_params") or {}).get("bc_values") or {}
    assert "_robin_update" not in bc
    assert r.get("html_path")


@pytest.mark.slow
def test_dim_switch_selfcontained_query_resets_stale_bcs(orch):
    """r5 battery-14 CLI finding: a 1D rod conversation followed by a
    self-contained 2D plate-in-air query ('with'/'and' classify it as a
    follow-up) dragged the rod's T_left/T_right Dirichlet edges into the
    plate solve."""
    run(orch.solve("Solve 1D heat transfer in a 2 meter rod, left end at "
                   "20°C, right end at 0°C"))
    r = run(orch.solve("A 1 m x 1 m granite plate starts at 500°C and "
                       "cools in 20°C air with a heat transfer coefficient "
                       "of 12. Show the first hour."))
    p = r["pde_params"]
    bc = p.get("bc_values") or {}
    assert "T_left" not in bc and "T_right" not in bc
    assert bc.get("all", {}).get("type") == "robin"
    assert bc["all"]["h"] == 12.0 and bc["all"]["T_ambient"] == 20.0
    assert p["dim"] == 2 and p["initial_value"] == 500.0


def test_pure_dim_switch_followup_keeps_bcs(orch):
    """A bare 'make it a 2D plate' follow-up (no boundary/initial data of
    its own) still inherits the previous BCs, reference-style."""
    run(orch.solve("Solve 1D heat transfer in a 2 meter rod, left end at "
                   "20°C, right end at 0°C"))
    r = run(orch.solve("make it a 2D plate instead"))
    bc = r["pde_params"].get("bc_values") or {}
    assert bc.get("T_left") == 20.0 and bc.get("T_right") == 0.0
    assert r["pde_params"]["dim"] == 2


# ---- round-5 NL battery 15: Kelvin units, fin base/tip faces, per-face
# distinct Dirichlet, ambient scoping across clauses, named-stress loads,
# math-notation T(0)/T(L)/alpha, t_final/half-an-hour durations ----

def test_rule_parse_battery_round15_kelvin_conversion():
    """Kelvin temperatures convert to Celsius up front ('900 K', '300 K
    surroundings'), while digits embedded in units (W/m2K) stay units and
    'half an hour' is a named duration."""
    r = rule_based_parse(
        "A steel block initially at 900 K cools by convection in 300 K "
        "surroundings with h = 40 W/m2K. Track the temperature for half "
        "an hour.")
    assert r["initial_value"] == pytest.approx(626.85)
    assert r["bc_values"]["all"] == {"type": "robin", "h": 40.0,
                                     "T_ambient": pytest.approx(26.85)}
    assert r["total_time"] == 1800.0


def test_rule_parse_battery_round15_fin_base_tip():
    """Fin vocabulary: 'base' is the clamped/heated end (x=0), 'tip' the
    far end; a unit-less 'h = 8' in a convection sentence is the film
    coefficient (it became an 8 m height); 'loses heat to 30C air' names
    the ambient; '0.5 m steel fin' captures the length through the
    interposed material word."""
    r = rule_based_parse(
        "A 0.5 m steel fin with base maintained at 200C, the tip is "
        "insulated. The fin loses heat to 30C air with h = 8. "
        "Simulate 600 seconds.")
    assert r["dim"] == 1
    assert r["domain_size"] == {"length": 0.5}
    bc = r["bc_values"]
    assert bc["T_left"] == 200.0
    assert bc["right"] == {"type": "insulated"}
    assert bc["all"] == {"type": "robin", "h": 8.0, "T_ambient": 30.0}
    assert r["total_time"] == 600.0


def test_rule_parse_battery_round15_cube_side_and_adiabatic_others():
    """'cube of side 0.3 m' must not become T_side=0.3; 'initially at a
    uniform 25°C' reads through the article/qualifier; a face with its own
    Dirichlet phrase survives 'all other faces are adiabatic'; 't_final ='
    is a duration cue."""
    r = rule_based_parse(
        "A cube of side 0.3 m is initially at a uniform 25°C. The bottom "
        "face is held at 40°C and all other faces are adiabatic. "
        "t_final = 100 s.")
    assert r["dim"] == 3
    assert r["domain_size"] == {"Lx": 0.3, "Ly": 0.3, "Lz": 0.3}
    assert r["initial_value"] == 25.0 and r["initial_type"] == "constant"
    bc = r["bc_values"]
    assert bc["bottom"] == {"type": "dirichlet", "value": 40.0}
    assert bc["sides"] == {"type": "insulated"}
    assert "T_side" not in bc and "T_bottom" not in bc
    assert r["total_time"] == 100.0


def test_rule_parse_battery_round15_math_notation():
    """T(0)=0 / T(L)=100 mathematical BCs (not just u(...)), and a bare
    'alpha = 9.7e-5' names the diffusivity in a heat context."""
    r = rule_based_parse(
        "Solve du/dt = alpha d2u/dx2 with alpha = 9.7e-5 on [0, L] with "
        "L = 1, T(0)=0, T(L)=100.")
    assert r["diffusivity"] == pytest.approx(9.7e-5)
    assert r["bc_values"]["T_left"] == 0.0
    assert r["bc_values"]["T_right"] == 100.0


def test_rule_parse_battery_round15_distinct_top_bottom_faces():
    """Distinct top/bottom temperatures cannot collapse into one uniform
    T_boundary (the bottom value was silently dropped) — they emit typed
    per-face Dirichlet specs instead."""
    r = rule_based_parse(
        "A square plate with the top edge at 100°C and the bottom edge at "
        "0°C, left and right sides insulated. Steady state.")
    bc = r["bc_values"]
    assert bc["top"] == {"type": "dirichlet", "value": 100.0}
    assert bc["bottom"] == {"type": "dirichlet", "value": 0.0}
    assert bc["left"] == {"type": "insulated"}
    assert bc["right"] == {"type": "insulated"}
    assert "T_boundary" not in bc
    assert r["steady"] is True


def test_rule_parse_battery_round15_pipe_ambient_scoping():
    """'fluid at 90°C flows inside … outside exposed to 20°C air': the
    inner Dirichlet reads through the interposed verb, and the outer
    Robin ambient must be the 20°C named in its own clause, not the 90°C
    leaking from the previous one."""
    r = rule_based_parse(
        "Water fluid at 90°C flows inside a steel pipe of inner radius "
        "2 cm and outer radius 3 cm; the outside is exposed to 20°C air "
        "with h = 15.")
    assert r["coordinate_system"] == "cylindrical"
    bc = r["bc_values"]
    assert bc["T_inner"] == 90.0
    assert bc["outer"] == {"type": "robin", "h": 15.0, "T_ambient": 20.0}


def test_rule_parse_battery_round15_named_stress_loads():
    """'30 MPa tension' / '50 MPa compression' are axial STRESSES →
    traction specs with sign, not point forces; the interposed-word rule
    reads 'a 2 m steel cantilever beam'."""
    r = rule_based_parse(
        "Apply 30 MPa of tension at the right end of a 2 m steel bar "
        "with E = 200 GPa and cross-section area 0.01 m2.")
    assert r["pde_type"] == "elasticity" and r["dim"] == 1
    assert r["domain_size"]["length"] == 2.0
    assert r["bc_values"]["right"] == {"type": "traction",
                                       "vector": [30.0e6]}
    assert r["material_params"]["area"] == 0.01

    c = rule_based_parse(
        "A 1 m aluminum bar under 50 MPa compression at the right end.")
    assert c["bc_values"]["right"] == {"type": "traction",
                                       "vector": [-50.0e6]}

    b = rule_based_parse("A 2 m steel cantilever beam under a 500 N tip "
                         "force.")
    assert b["domain_size"]["length"] == 2.0


def test_rule_parse_battery_round15_volumetric_unit_source_first():
    """A volumetric power-density unit carries its own scale and wins over
    the bare-number phrase rules: 'volumetric heating of 2 MW/m³' is 2e6,
    not 2."""
    r = rule_based_parse(
        "A 1 m rod with volumetric heating of 2 MW/m³, ends at 0°C.")
    assert r["source_type"] == "constant"
    assert r["source_value"] == pytest.approx(2.0e6)
    assert r["bc_values"]["T_left"] == 0.0
    assert r["bc_values"]["T_right"] == 0.0


def test_rule_parse_battery_round15_bare_ends_dirichlet():
    """Bare 'ends at 0°C' (no 'both') is the symmetric Dirichlet pair; the
    two-value 'ends at 100 and 0' order is preserved and not claimed by
    the symmetric rule."""
    assert rule_based_parse("A 1 m rod, ends at 0°C.")["bc_values"] \
        == {"T_left": 0.0, "T_right": 0.0}
    assert rule_based_parse("A 1 m rod with ends kept at 0 degrees."
                            )["bc_values"] \
        == {"T_left": 0.0, "T_right": 0.0}
    two = rule_based_parse("A 1 m rod, ends at 100 and 0 degrees.")
    assert two["bc_values"]["T_left"] == 100.0
    assert two["bc_values"]["T_right"] == 0.0


def test_rule_parse_battery_round15_medium_first_immersion():
    """'placed in water at 20°C, h = 500' — medium-first immersion with
    the ambient after the medium word is a convection cue."""
    r = rule_based_parse(
        "A 5 cm aluminum sphere initially at 150°C is placed in water at "
        "20°C, h = 500. Simulate 120 seconds.")
    assert r["bc_values"]["all"] == {"type": "robin", "h": 500.0,
                                     "T_ambient": 20.0}
    assert r["initial_value"] == 150.0
    assert r["total_time"] == 120.0


def test_dispatcher_battery_round15_traction_end_load():
    """1D elasticity traction/pressure specs reach the bar solver as
    end_load = sigma * area (pressure pushes inward → negative)."""
    d = DispatcherAgent()
    p = PDEParameters(pde_type="elasticity", dim=1,
                      domain_size={"length": 2.0}, young_modulus=2e11,
                      material_params={"area": 0.01},
                      bc_values={"right": {"type": "traction",
                                           "vector": [3.0e7]}})
    name, args = d.route(p)
    assert name == "solve_elasticity_1D_loaded"
    assert args["end_load"] == pytest.approx(3.0e5)
    assert args["area"] == 0.01

    p2 = PDEParameters(pde_type="elasticity", dim=1,
                       domain_size={"length": 2.0},
                       bc_values={"right": {"type": "pressure",
                                            "value": 5.0e6}})
    _, args2 = d.route(p2)
    assert args2["end_load"] == pytest.approx(-5.0e6)  # default unit area


# ---- round-5 NL battery 16: diameters, carried-fluid pipes, slab/wafer
# through-thickness lengths, one-face/other-face pairs, qualified-air
# convection cues, immersion initial states, micron units ----

def test_rule_parse_battery_round16_diameter_pipe():
    """'inner diameter 5 cm and outer diameter 6 cm' is the annulus radius
    pair (the generic diameter rule grabbed one solid radius); 'Steam at
    120°C flows in a pipe' wets the inner surface; 'Outside air at 25°C
    with h = 10' is a convection cue whose face word sits inside the cue
    itself — and that unit-less h must not become a 10 m height."""
    r = rule_based_parse(
        "Steam at 120°C flows in a copper pipe with inner diameter 5 cm "
        "and outer diameter 6 cm. Outside air at 25°C with h = 10. "
        "Steady state.")
    assert r["dim"] == 1 and r["coordinate_system"] == "cylindrical"
    assert r["geometry_params"] == {"r_inner": 0.025, "r_outer": 0.03}
    assert r["bc_values"]["T_inner"] == 120.0
    assert r["bc_values"]["outer"] == {"type": "robin", "h": 10.0,
                                       "T_ambient": 25.0}
    assert "h" not in (r.get("domain_size") or {})
    assert r["steady"] is True


def test_rule_parse_battery_round16_carries_fluid():
    r = rule_based_parse(
        "A steel pipe carries oil at 80°C, inner radius 2 cm, outer "
        "radius 3 cm, outer surface at 20°C.")
    assert r["bc_values"]["T_inner"] == 80.0
    assert r["bc_values"]["T_outer"] == 20.0


def test_rule_parse_battery_round16_slab_thickness_is_length():
    """For a planar conduction object (slab/wall/wafer) 'X thick' IS the
    conduction path; 'one face at -10°C and the other at 22°C' is the
    left/right pair (both were dropped and the slab solved a default-1 m
    domain)."""
    r = rule_based_parse(
        "A concrete slab 20 cm thick has one face at -10°C and the other "
        "at 22°C. Conductivity 1.4 W/mK. Steady-state profile?")
    assert r["dim"] == 1
    assert r["domain_size"]["length"] == pytest.approx(0.2)
    assert r["bc_values"]["T_left"] == -10.0
    assert r["bc_values"]["T_right"] == 22.0
    assert r["diffusivity"] == pytest.approx(1.4)

    # the reference's CRITICAL thin-conductor rule is untouched: a bare
    # thickness WITHOUT a planar-object word stays a material note
    c = rule_based_parse("a 30nm thick conductor carrying current")
    assert "length" not in (c.get("domain_size") or {})
    assert any("Thickness mentioned" in n for n in c.get("notes", []))


def test_rule_parse_battery_round16_wafer_microns_top_bottom():
    """Micron units scale ('300 microns thick' wafer), and a 1D
    through-thickness problem stated with top/bottom faces maps bottom→x=0
    and top→x=L as plain Dirichlet ends."""
    r = rule_based_parse(
        "A silicon wafer 300 microns thick, top surface at 80°C, "
        "bottom at 20°C.")
    assert r["dim"] == 1
    assert r["domain_size"]["length"] == pytest.approx(300e-6)
    assert r["bc_values"]["T_left"] == 20.0
    assert r["bc_values"]["T_right"] == 80.0
    assert "top" not in r["bc_values"] and "bottom" not in r["bc_values"]


def test_rule_parse_battery_round16_shaft_in_diameter():
    """Value-first diameter ('a shaft 5 cm in diameter') makes the shaft a
    cylinder with the right radius; '1 m long' stays the axial length."""
    r = rule_based_parse(
        "A steel shaft 5 cm in diameter and 1 m long, its surface held at "
        "80°C, initially 20°C. Simulate 2 minutes.")
    assert r["geometry_type"] == "cylinder"
    assert r["geometry_params"]["cylinder_radius"] == pytest.approx(0.025)
    assert r["bc_values"]["T_boundary"] == 80.0
    assert r["initial_value"] == 20.0 and r["total_time"] == 120.0


def test_rule_parse_battery_round16_immersion_initial_state():
    """'a 7 cm sphere at 20°C goes into a 180°C oven' — the body
    temperature right before the immersion verb is the initial state (it
    was silently dropped)."""
    r = rule_based_parse(
        "A potato, roughly a 7 cm sphere at 20°C, goes into a 180°C oven "
        "with h = 25. Simulate 40 minutes.")
    assert r["initial_value"] == 20.0
    assert r["bc_values"]["all"] == {"type": "robin", "h": 25.0,
                                     "T_ambient": 180.0}
    assert r["total_time"] == 2400.0


def test_rule_parse_battery_round16_wall_thickness_conduction_path():
    r = rule_based_parse(
        "A basement wall 3 m tall and 25 cm thick, inside at 18°C, "
        "outside at -5°C.")
    assert r["dim"] == 1
    assert r["domain_size"]["length"] == pytest.approx(0.25)
    assert r["bc_values"]["T_left"] == 18.0
    assert r["bc_values"]["T_right"] == -5.0


def test_rule_parse_battery_round16_sinusoidal_top_face_kept():
    """The 1D top/bottom→ends remap must NOT swallow a sinusoidally-driven
    face spec (amplitude/period stay typed)."""
    r = rule_based_parse(
        "ground temperature under a daily cycle between -5 and 15 C at "
        "the top surface, 2 m deep domain")
    spec = r["bc_values"]["top"]
    assert spec["amplitude"] == 10.0 and spec["period"] == 86400.0


# ---- round-5 NL battery 17: follow-up merge conflicts (face BC
# representations, load updates, source removal, transient switch) and
# number-first / verb-only force phrasings ----

def test_followup_robin_replaces_same_face_dirichlet(orch):
    """'add convection on the right' must DROP the previous T_right
    Dirichlet (both coexisted and the solve saw conflicting BCs on one
    face); a later 'set the right end to 50C' swaps back."""
    run(orch.solve("Solve 1D heat transfer in a 2 meter rod, left end at "
                   "20C, right end at 0C"))
    r = run(orch.solve("add convection on the right with h = 15 and "
                       "ambient 25C"))
    bc = r["pde_params"]["bc_values"]
    assert bc["right"] == {"type": "robin", "h": 15.0, "T_ambient": 25.0}
    assert "T_right" not in bc and bc["T_left"] == 20.0

    r2 = run(orch.solve("set the right end to 50C"))
    bc2 = r2["pde_params"]["bc_values"]
    assert bc2["T_right"] == 50.0 and "right" not in bc2


def test_rule_parse_battery_round17_force_phrasings():
    """Number-first ('a 500 N axial force'), noun-late ('a 500 N force at
    the right end'), and verb-only ('pull ... with 500 N') all classify as
    elasticity and capture the axial load (all three routed to heat with
    no load)."""
    for text in (
            "A 2 m steel bar fixed at the left end with a 500 N axial "
            "force at the right end",
            "a 1 m bar with a 500 N force at the right end",
            "pull the right end of a 1 m steel bar with 500 N"):
        r = rule_based_parse(text)
        assert r["pde_type"] == "elasticity", text
        assert r["bc_values"]["right"] == {"type": "force_axial",
                                           "value": 500.0}, text
    # thermal guard: a heat source 'of 5' stays heat
    h = rule_based_parse("heat a 1 m rod with a heat source of 5, "
                         "left end at 0C")
    assert h["pde_type"] == "heat" and h["source_value"] == 5.0


def test_followup_load_increase_and_material_switch(orch):
    """An elasticity conversation: 'increase the load to 2 kN' updates the
    end load in place; strain/material follow-ups layer on without
    touching it."""
    run(orch.solve("A 2 m steel bar fixed at the left end with a 500 N "
                   "axial force at the right end"))
    r = run(orch.solve("increase the load to 2 kN"))
    p = r["pde_params"]
    assert p["bc_values"]["right"] == {"type": "force_axial",
                                       "value": 2000.0}
    r2 = run(orch.solve("show me the strain instead"))
    assert r2["pde_params"]["material_params"]["quantity"] == "strain"
    r3 = run(orch.solve("use aluminum with E = 70 GPa"))
    p3 = r3["pde_params"]
    assert p3["young_modulus"] == pytest.approx(70e9)
    assert p3["bc_values"]["right"]["value"] == 2000.0


def test_followup_source_removal_and_transient_switch(orch):
    """'remove the heat source' clears it (it silently persisted), and
    'make it transient' overrides a previous steady=True."""
    run(orch.solve("Steady heat in a 1 m rod, left at 100C, right at 0C, "
                   "with a heat source of 5"))
    r = run(orch.solve("remove the heat source"))
    p = r["pde_params"]
    assert p["source_type"] == "none" and p.get("source_value") is None
    r2 = run(orch.solve("make it transient and show 60 seconds"))
    p2 = r2["pde_params"]
    assert p2["steady"] is False and p2["total_time"] == 60.0


def test_rule_parse_battery_round17_transient_keyword():
    assert rule_based_parse("transient heat in a 1 m rod")["steady"] is False
    assert rule_based_parse("steady heat in a 1 m rod")["steady"] is True


# ---- round-5 NL battery 18: flux face attribution vs Dirichlet faces,
# A×B×C vs single-length conflicts, corridor-style domains ----

def test_rule_parse_battery_round18_flux_face_attribution():
    """'left end receives a heat flux of 1000 W/m2, right end at 0C' hung
    a spurious Neumann on the right (the prefer-after face search jumped
    over the comma onto a face with its own Dirichlet phrase)."""
    r = rule_based_parse("A 1 m rod, left end receives a heat flux of "
                         "1000 W/m2, right end at 0C.")
    bc = r["bc_values"]
    assert bc["left"] == {"type": "neumann", "flux": 1000.0}
    assert bc["T_right"] == 0.0
    assert "right" not in bc

    # face named AFTER the flux still wins when it has no Dirichlet
    a = rule_based_parse("A 1 m rod with the right end at 0C. Apply a "
                         "heat flux of 500 W/m2 on the left end.")
    assert a["bc_values"]["left"] == {"type": "neumann", "flux": 500.0}
    assert "right" not in a["bc_values"]

    p = rule_based_parse("apply a heat flux of 500 to the top of a "
                         "1 m x 1 m plate")
    assert p["bc_values"]["top"] == {"type": "neumann", "flux": 500.0}


def test_rule_parse_battery_round18_box_no_spurious_length():
    """'a 1 m x 0.2 m x 0.2 m steel beam' must not ALSO set a 1D length
    from its last factor via the interposed-words rod/beam rule."""
    r = rule_based_parse("Find the vibration modes of a 1 m x 0.2 m x "
                         "0.2 m steel beam.")
    assert r["domain_size"] == {"Lx": 1.0, "Ly": 0.2, "Lz": 0.2}
    assert "length" not in r["domain_size"]
    assert r["dim"] == 3 and "modal" in r["notes"]


def test_rule_parse_battery_round18_corridor_advection():
    r = rule_based_parse("Smoke advects through a 10 m corridor with air "
                         "moving at 2 m/s, diffusivity 0.01. Track 5 "
                         "seconds.")
    assert r["pde_type"] == "advection"
    assert r["domain_size"]["length"] == 10.0
    assert r["material_params"]["velocity"] == 2.0
    assert r["diffusivity"] == pytest.approx(0.01)
    assert r["total_time"] == 5.0


# ---- round-5 NL battery 19: cladding vs core diffusivity, kappa(T)
# formulas, unit words in number-first face rules, honest nonlinear
# fallthrough + user-facing notes ----

def test_rule_parse_battery_round19_cladding_vs_core_diffusivity():
    """'core diffusivity 10, cladding diffusivity 1' — the bulk value is
    the cladding's (the core value was claimed for BOTH)."""
    r = rule_based_parse(
        "A nuclear fuel rod 1 cm radius with a high-conductivity core of "
        "radius 0.3 cm, core diffusivity 10, cladding diffusivity 1, "
        "surface at 300C, 2 minutes.")
    assert r["diffusivity"] == 1.0
    assert r["core_diffusivity"] == 10.0
    assert r["core_radius"] == pytest.approx(0.003)
    assert r["geometry_params"]["cylinder_radius"] == pytest.approx(0.01)


def test_rule_parse_battery_round19_kappa_formula():
    """'k = 20*(1 + 0.005 T)' carries kappa0 AND beta and is itself the
    nonlinear cue (the formula parsed as nothing at all)."""
    r = rule_based_parse("Conductivity varies as k = 20*(1 + 0.005 T) in "
                         "a 1 m rod, ends at 0 and 100C.")
    assert "nonlinear_kappa" in r["notes"]
    assert r["diffusivity"] == 20.0
    assert r["material_params"]["beta"] == pytest.approx(0.005)
    # minus sign → negative beta
    d = rule_based_parse("A 1 m rod with kappa = 50*(1 - 0.002*T), "
                         "ends at 0C and 100C.")
    assert d["material_params"]["beta"] == pytest.approx(-0.002)
    assert d["diffusivity"] == 50.0


def test_rule_parse_battery_round19_unit_word_not_inner_temp():
    """'height 20 cm inside a box' — the interposed-word allowance in the
    number-first inside/outside rule must not let a length unit slip in
    (it produced T_inner=20 from the HEIGHT)."""
    r = rule_based_parse(
        "A copper cylinder of radius 5 cm and height 20 cm inside a box, "
        "left end heated to 150C, right end at 10C.")
    bc = r["bc_values"]
    assert bc["T_left"] == 150.0 and bc["T_right"] == 10.0
    assert "T_inner" not in bc
    # the genuine number-first phrasing still works
    w = rule_based_parse("water at 80 C inside and 20 C on the outside of "
                         "a pipe with inner radius 2 cm and outer radius "
                         "4 cm")
    assert w["bc_values"]["T_inner"] == 80.0
    assert w["bc_values"]["T_outer"] == 20.0


def test_dispatcher_battery_round19_nonlinear_fallthrough_note(orch):
    """A transient kappa(T) query cannot use the steady Picard tool — the
    solve proceeds with constant kappa0 and SAYS so; the steady variant
    routes to the nonlinear tool with no such note."""
    r = run(orch.solve("A 1 m rod with kappa = 50*(1 + 0.002*T), ends at "
                       "0C and 100C, simulate 60 seconds"))
    assert "Note: temperature-dependent conductivity requested" \
        in r["summary"]
    r2 = run(orch.solve(
        "Steady heat in a 1 m rod with kappa = 50*(1 + 0.002*T), "
        "ends at 0C and 100C"))
    assert "Note: temperature-dependent" not in r2["summary"]


def test_summary_surfaces_sentence_notes(orch):
    """Sentence-like parser notes (capability warnings) reach the summary;
    single-token internal flags never do."""
    r = run(orch.solve("a steel bar clamped at both ends under gravity, "
                       "1 m long"))
    assert "Note: both-ends fixity requested" in r["summary"]
    assert "Note: dynamic" not in r["summary"]


# ---- round-5 NL battery 20: Fahrenheit, spelled-out signs, half-lengths ----

def test_rule_parse_battery_round20_fahrenheit():
    """'212 F' was silently read as 212 °C — Fahrenheit now converts up
    front like Kelvin."""
    r = rule_based_parse("A 1 m rod with the left end at 212 F and the "
                         "right end at 32 F.")
    assert r["bc_values"]["T_left"] == pytest.approx(100.0)
    assert r["bc_values"]["T_right"] == pytest.approx(0.0)


def test_rule_parse_battery_round20_minus_and_half():
    r = rule_based_parse("left end at minus 10 C, right end at 25 C, "
                         "1 m rod")
    assert r["bc_values"]["T_left"] == -10.0
    assert r["bc_values"]["T_right"] == 25.0

    h = rule_based_parse("a half-metre rod with ends at 0C")
    assert h["domain_size"]["length"] == 0.5
    assert h["bc_values"] == {"T_left": 0.0, "T_right": 0.0}
    # "one and a half metres" must NOT become 0.5
    g = rule_based_parse("a one and a half metre rod at 20C")
    assert (g.get("domain_size") or {}).get("length") != 0.5


# ---- round-5 NL battery 21: applied-scenario prompts (cube center,
# coffee mug, soil temperature wave) ----

def test_rule_parse_battery_round21_cube_center_question():
    """Value-first cube side ('a 10 cm aluminum cube') — the side was
    dropped and the solve used a default domain."""
    r = rule_based_parse(
        "What is the temperature at the center of a 10 cm aluminum cube "
        "after 5 minutes if all faces are held at 0C and it starts at "
        "100C?")
    assert r["domain_size"] == {"Lx": 0.1, "Ly": 0.1, "Lz": 0.1}
    assert r["initial_value"] == 100.0
    assert r["bc_values"]["T_boundary"] == 0.0
    assert r["total_time"] == 300.0


def test_rule_parse_battery_round21_coffee_mug():
    """'8 cm diameter, 10 cm tall cylinder with h = 6 ... it cools': the
    diameter parses value-first without 'in', the film-coefficient h must
    not overwrite the 10 cm height, the 20°C ROOM is the ambient, and
    'at 85C sits in' is the initial state."""
    r = rule_based_parse(
        "A mug of coffee at 85C sits in a 20C room. The mug is roughly a "
        "8 cm diameter, 10 cm tall cylinder with h = 6. How does it cool "
        "over 30 minutes?")
    assert r["geometry_params"]["cylinder_radius"] == pytest.approx(0.04)
    assert r["domain_size"]["h"] == pytest.approx(0.1)
    assert r["bc_values"]["all"] == {"type": "robin", "h": 6.0,
                                     "T_ambient": 20.0}
    assert r["initial_value"] == 85.0
    assert r["total_time"] == 1800.0
    assert not any("without an ambient" in n for n in r.get("notes", []))


def test_rule_parse_battery_round21_temperature_wave_stays_heat():
    """'the daily temperature wave' routed to the WAVE EQUATION — a
    temperature/thermal/heat-qualified 'wave' stays heat; the genuine wave
    route is untouched."""
    r = rule_based_parse(
        "How deep does the daily temperature wave penetrate into soil "
        "with diffusivity 5e-7? Surface varies between 10 and 30C with a "
        "period of 24 hours, 2 m deep domain.")
    assert r["pde_type"] == "heat"
    assert r["bc_values"]["all"]["period"] == 86400.0
    w = rule_based_parse("A 2 m guitar string with wave speed 340.")
    assert w["pde_type"] == "wave"


# ---- round-5 NL battery 22: plane-strain mode vs strain output, 'loaded
# by' forces, noun pulls, bare nu ----

def test_rule_parse_battery_round22_plane_strain_not_quantity():
    """'plane strain' is an analysis MODE — it must not flip the output
    quantity to strain; an explicit 'find the strain' still does."""
    r = rule_based_parse("A long retaining wall cross-section 2 m x 1 m "
                         "under plane strain, gravity load, density 2400, "
                         "E = 30 GPa.")
    mp = r["material_params"]
    assert mp["plane_stress"] is False
    assert "quantity" not in mp
    s = rule_based_parse("find the strain in a 1 m bar under a 500 N "
                         "axial force")
    assert s["material_params"]["quantity"] == "strain"


def test_rule_parse_battery_round22_loaded_by_and_pull_noun():
    """'loaded by 10 kN at the free end' and 'under a 10 kN pull' both
    lost the force; bare 'nu 0.3' lost the Poisson ratio."""
    r = rule_based_parse("Compute the von Mises stress in a 2 m x 0.5 m "
                         "bracket loaded by 10 kN at the free end, "
                         "E 200 GPa, nu 0.3.")
    assert r["poisson_ratio"] == 0.3
    assert r["bc_values"]["right"] == {"type": "force",
                                       "vector": [0.0, -10000.0]}
    p = rule_based_parse("How much does a 1 m steel rod stretch under a "
                         "10 kN pull? Area 1 cm2.")
    assert p["bc_values"]["right"] == {"type": "force_axial",
                                       "value": 10000.0}
    assert p["material_params"]["area"] == pytest.approx(1e-4)


# ---- round-5 NL battery 23: unicode sci-notation & minus, ms durations,
# spelled compound hours, blowing velocity, internal pressure, value-first
# walls, both-faces pairs, through-thickness plates, honesty notes ----

def test_rule_parse_battery_round23_unicode_scientific_notation():
    """'α = 1.2×10⁻⁵' parsed as diffusivity 1.2 (100000x wrong) AND left a
    spurious '1.2 x 10' 2D domain behind."""
    r = rule_based_parse("Rod of length 0.8 m, α = 1.2×10⁻⁵ m²/s, left "
                         "end 90 °C, right end 10 °C, run for 600 s.")
    assert r["diffusivity"] == pytest.approx(1.2e-5)
    assert r["domain_size"] == {"length": 0.8}
    assert r["bc_values"]["T_left"] == 90.0
    assert r["bc_values"]["T_right"] == 10.0
    assert r["total_time"] == 600.0
    c = rule_based_parse("diffusivity of 2.5 x 10^-6, 1 m rod")
    assert c["diffusivity"] == pytest.approx(2.5e-6)


def test_rule_parse_battery_round23_unicode_minus_bc():
    """'right −50C' (U+2212 minus) silently dropped the boundary value."""
    r = rule_based_parse("A plate 40cm×20cm, k = 2.5e1 W/mK, left 200C, "
                         "right −50C, steady state.")
    assert r["bc_values"]["T_left"] == 200.0
    assert r["bc_values"]["T_right"] == -50.0
    assert r["domain_size"] == {"Lx": 0.4, "Ly": 0.2}


def test_rule_parse_battery_round23_millisecond_durations():
    """'for 20 ms' / 'simulate 1.5 ms' produced no total_time at all."""
    r = rule_based_parse("A 1.2 m organ pipe is excited acoustically; "
                         "wave speed 340 m/s. Simulate the pressure "
                         "oscillation for 20 ms.")
    assert r["total_time"] == pytest.approx(0.02)
    s = rule_based_parse("A 1 mm gold wire initially at 300°C cools in "
                         "25°C air (h = 80) — simulate 1.5 ms.")
    assert s["total_time"] == pytest.approx(1.5e-3)
    assert s["initial_value"] == 300.0
    w = rule_based_parse("A circular drumhead 30 cm in diameter is "
                         "struck in the middle. Wave speed 100 m/s. "
                         "Show the first 10 ms.")
    assert w["total_time"] == pytest.approx(0.01)
    assert w["wave_speed"] == 100.0


def test_rule_parse_battery_round23_compound_spelled_hours():
    """'for two and a half hours' / 'an hour and a half' parsed nothing
    ('half an hour' alone was covered)."""
    r = rule_based_parse("Heat a frozen 25 cm soil column (initially "
                         "-10°C) from the top at 15°C for two and a "
                         "half hours.")
    assert r["total_time"] == pytest.approx(9000.0)
    assert r["domain_size"]["length"] == pytest.approx(0.25)
    assert r["initial_value"] == -10.0
    s = rule_based_parse("simulate a 1 m rod for an hour and a half")
    assert s["total_time"] == pytest.approx(5400.0)
    h = rule_based_parse("cool the 1 m rod for half an hour")
    assert h["total_time"] == pytest.approx(1800.0)


def test_rule_parse_battery_round23_wind_blowing_velocity():
    """'Wind blowing at 3 m/s carries smoke...' lost the advection
    velocity entirely."""
    r = rule_based_parse("Wind blowing at 3 m/s carries smoke down a "
                         "50 m corridor. Diffusivity 0.1 m²/s. Where is "
                         "the smoke after 30 seconds?")
    assert r["pde_type"] == "advection"
    assert r["material_params"]["velocity"] == 3.0
    assert r["domain_size"]["length"] == 50.0
    assert r["total_time"] == 30.0


def test_rule_parse_battery_round23_internal_pressure_inner_face():
    """A 5 MPa INTERNAL pressure landed on the outer wall of the pipe."""
    r = rule_based_parse("A pressurized steel pipe, inner radius 5 cm, "
                         "outer radius 6 cm, carries an internal "
                         "pressure of 5 MPa. Hoop stress?")
    assert r["bc_values"]["inner"] == {"type": "pressure",
                                       "value": 5e6}
    assert "outer" not in r["bc_values"]
    assert r["geometry_params"] == {"r_inner": 0.05, "r_outer": 0.06}


def test_rule_parse_battery_round23_value_first_wall_and_both_faces():
    """'a 30 cm concrete wall' (no 'thick' keyword) solved a default 1 m
    domain, and 'both faces sit at 15°C' set no BC at all."""
    r = rule_based_parse("How much hotter is the center of a 30 cm "
                         "concrete wall than its faces at steady state, "
                         "if it generates 400 W/m³ and both faces sit "
                         "at 15°C?")
    assert r["domain_size"]["length"] == pytest.approx(0.3)
    assert r["bc_values"]["T_left"] == 15.0
    assert r["bc_values"]["T_right"] == 15.0
    assert r["source_value"] == 400.0
    assert r["steady"] is True


def test_rule_parse_battery_round23_keep_ends_adjective():
    """'Keep the ends of a 60 cm copper rod ice-cold at 0°C' — the
    adjective+object between 'ends' and the value lost both BCs."""
    r = rule_based_parse("Keep the ends of a 60 cm copper rod ice-cold "
                         "at 0°C while the middle 10 cm is heated at "
                         "5000 W/m³. Steady profile?")
    assert r["bc_values"]["T_left"] == 0.0
    assert r["bc_values"]["T_right"] == 0.0
    assert r["domain_size"]["length"] == pytest.approx(0.6)


def test_rule_parse_battery_round23_through_thickness_plate():
    """A plate with top/bottom temperatures asked 'through the thickness'
    must become the 1D wall problem, not a 2D plate with a default
    domain ('It is 4 cm thick' in its own sentence)."""
    r = rule_based_parse("A steel plate sits outside overnight: its top "
                         "surface drops to -5°C while the bottom stays "
                         "at 12°C. It is 4 cm thick. Steady temperature "
                         "through the thickness?")
    assert r["dim"] == 1
    assert r["domain_size"]["length"] == pytest.approx(0.04)
    assert r["bc_values"]["T_left"] == 12.0   # bottom = x=0
    assert r["bc_values"]["T_right"] == -5.0  # top = x=L


def test_rule_parse_battery_round23_honesty_notes():
    """Step/Gaussian initial profiles and radiation BCs must be flagged,
    not silently replaced; a 'background' temperature is the uniform
    initial value."""
    r = rule_based_parse("A 1 m steel rod: initially the left half is "
                         "at 100°C and the right half is at 0°C. Both "
                         "ends are insulated. How does the temperature "
                         "even out over 10 minutes?")
    assert any("Non-uniform initial" in n for n in r.get("notes", []))
    g = rule_based_parse("A 2 m rod starts with a Gaussian hot spot of "
                         "80°C in the middle, on top of a 20°C "
                         "background. Ends held at 20°C. Simulate 5 "
                         "minutes.")
    assert g["initial_value"] == 20.0
    assert any("Non-uniform initial" in n for n in g.get("notes", []))
    d = rule_based_parse("A 2 cm steel plate at 800°C radiates to cold "
                         "surroundings at 25°C with emissivity 0.8. How "
                         "fast does it cool?")
    assert any("Radiative heat exchange" in n for n in d.get("notes", []))


def test_rule_parse_battery_round23_column_length():
    """'a 10 m concrete column' lost its length (column was a cylinder
    cue but not a 1D length noun)."""
    r = rule_based_parse("How much does a 10 m concrete column compress "
                         "under its own weight? Density 2400 kg/m³, "
                         "E = 30 GPa.")
    assert r["pde_type"] == "elasticity"
    assert r["domain_size"]["length"] == pytest.approx(10.0)
    assert r["young_modulus"] == pytest.approx(30e9)
    assert r["density"] == 2400.0
    assert r["material_params"]["gravity"] is True


def test_rule_parse_battery_round23_distributed_load():
    """'a uniformly distributed load of 2 kN/m' became a 2 kN END force;
    and the upgraded bending plane dropped the beam's 3 m span for the
    1 m default.  The UDL rides material_params and the dispatcher
    smears it over the (slender-default) section as a body force."""
    r = rule_based_parse("A 3 m steel beam carries a uniformly "
                         "distributed load of 2 kN/m. The left end is "
                         "fixed. Deflection?")
    assert r["pde_type"] == "elasticity"
    assert r["dim"] == 2
    assert r["material_params"]["udl"] == 2000.0
    assert "right" not in r.get("bc_values", {})
    args = DispatcherAgent()._elast_2d_args(PDEParameters.from_dict(r))
    assert args["Lx"] == 3.0
    assert args["Ly"] == pytest.approx(0.3)
    assert args["body_fy"] == pytest.approx(-2000.0 / 0.3)
    # per-meter phrasing without 'distributed'
    p = rule_based_parse("A 4 m beam under 500 N per meter, clamped at "
                         "the left end.")
    assert p["material_params"]["udl"] == 500.0
    # point forces are untouched
    q = rule_based_parse("A 2 m steel cantilever beam with a 5 kN "
                         "downward force at the free end.")
    assert q["bc_values"]["right"] == {"type": "force",
                                       "vector": [0.0, -5000.0]}
    qa = DispatcherAgent()._elast_2d_args(PDEParameters.from_dict(q))
    assert qa["Lx"] == 2.0 and qa["Ly"] == pytest.approx(0.2)


def test_rule_parse_battery_round23_deflection_quantity():
    """'Deflection?' / 'how much does it stretch' were answered with von
    Mises stress (the reference clamps quantity to stress|strain) — the
    extension returns the actual displacement field."""
    r = rule_based_parse("A 3 m steel beam carries a uniformly "
                         "distributed load of 2 kN/m. The left end is "
                         "fixed. Deflection?")
    assert r["material_params"]["quantity"] == "displacement"
    s = rule_based_parse("How much does a 1 m steel rod stretch under a "
                         "10 kN pull? Area 1 cm2.")
    assert s["material_params"]["quantity"] == "displacement"
    # explicit stress/strain requests are untouched
    q = rule_based_parse("von Mises stress in a 2 m cantilever under a "
                         "1 kN downward force")
    assert q.get("material_params", {}).get("quantity") != "displacement"


def test_rule_parse_battery_round24_imperial_lengths():
    """Imperial lengths normalize to metres up front ('a 6 inch thick
    concrete slab' and 'a 3 ft long rod' silently solved default
    domains)."""
    r = rule_based_parse("a 6 inch thick concrete slab, one face at 40 C "
                         "the other at 10 C")
    assert r["domain_size"]["length"] == pytest.approx(0.1524)
    # connector-free 'one face ... the other' pair (both were dropped)
    assert r["bc_values"]["T_left"] == 40.0
    assert r["bc_values"]["T_right"] == 10.0
    s = rule_based_parse("a 3 ft long steel rod heated to 200 C at the "
                         "left end, right end at 0 C")
    assert s["domain_size"]["length"] == pytest.approx(0.9144)
    # temperature-first face phrasing ('heated to X at the left end')
    assert s["bc_values"]["T_left"] == 200.0
    assert s["bc_values"]["T_right"] == 0.0
    # bare "in" stays a preposition, '"' stays a quote
    q = rule_based_parse("a rod 2 m in length at 100 C on the left")
    assert q["domain_size"]["length"] == 2.0


def test_rule_parse_battery_round24_elastic_column():
    """'a 2 m aluminum column compressed by 50 kN' routed to a heat
    cylinder — 'column' is a cylinder word for heat only, 'compressed by'
    is a mechanical-load cue, and the load is captured signed."""
    r = rule_based_parse("a 2 m aluminum column compressed by 50 kN")
    assert r["pde_type"] == "elasticity"
    assert r["dim"] == 1
    assert r.get("geometry_type") != "cylinder"
    assert r["bc_values"]["right"] == {"type": "force_axial",
                                       "value": -50000.0}
    d = DispatcherAgent()
    name, _ = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_1D_loaded"
    # heat columns keep the reference's cylinder-keyword behavior
    h = rule_based_parse("steel column 3 m tall, base at 100 C")
    assert h["pde_type"] == "heat"
    assert h["geometry_type"] == "cylinder"


def test_rule_parse_battery_round24_brick_material_and_sections():
    """'brick wall'/'of brick' name the material, not a 3D box; 'square
    cross-section' describes the section, not a 2D domain."""
    r = rule_based_parse("a brick wall 30 cm thick, inside at 20 C and "
                         "outside at -5 C")
    assert r.get("geometry_type") != "box"
    assert r["dim"] == 1
    assert r["domain_size"]["length"] == pytest.approx(0.3)
    assert r["bc_values"]["T_left"] == 20.0
    assert r["bc_values"]["T_right"] == -5.0
    s = rule_based_parse("how long to conduct through 10 cm of brick with "
                         "faces at 30 C and 5 C")
    assert s.get("geometry_type") != "box" and s["dim"] == 1
    # a bare brick object is still the box shape
    b = rule_based_parse("a clay brick heated to 200 C on all faces")
    assert b["geometry_type"] == "box" and b["dim"] == 3
    q = rule_based_parse("a steel bar with a 5 cm square cross-section, "
                         "2 m long, pulled with 10 kN")
    assert q["pde_type"] == "elasticity" and q["dim"] == 1
    assert q["domain_size"]["length"] == 2.0
    assert q["bc_values"]["right"] == {"type": "force_axial",
                                       "value": 10000.0}
