"""The Steckler compartment fire as FireFOAM-dev's `cases/steckler` lays it
out, written by the benchmark itself.

The domain is the demo case's block, [-2, 4] x [0, 3] x [-2, 2] m with y up.
The room of Steckler, Quintiere and Rinkinen (NBSIR 82-2520) stands in it:
2.8 m x 2.8 m in plan about the origin, 2.18 m high, with one doorway
0.74 m wide and 1.83 m high centred in its wall at x = +1.4 m, and the
square burner of 0.3048 m centred on its floor. Outside the room the air
is open at the block's sides and top; the ground is a wall. The room's
walls and ceiling are zero-thickness baffles (createBaffles) in the
lattice, as the demo makes its compartment, so the mesh keeps the DIA
lattice of one block. Every plane is snapped to the lattice of cell size
`h`: at 0.1 m and 0.2 m the room, ceiling and burner fall on it as
published, and the door is 0.8 m x 1.8 m.

The dictionaries are the steckler family's: propane on a single-step
reaction under the eddy-dissipation model, kEqn LES, PISO with two
correctors, grey fvDOM with 16 rays every 10th step, an adjustable time
step at maxCo 0.9. The burner feeds propane at `hrr_kw` over the golden
log's heat of combustion.

    python3 benchmark/cases/steckler_room.py <dir> [h]   # writes a case
"""

from __future__ import annotations

import os
import sys

# the golden log's 'Fuel heat of combustion' of the steckler case, J/kg
Q_FUEL = 46357151.0
SPECIES = ("O2", "H2O", "C3H8", "CO2", "N2")

THERMO_GAS = """FoamFile { version 2.0; format ascii; class dictionary; object thermo.gas; }
O2 {
    specie { nMoles 1; molWeight 31.9988; }
    thermodynamics { Tlow 200; Thigh 5000; Tcommon 1000;
        highCpCoeffs ( 3.69758 0.00061352 -1.25884e-07 1.77528e-11 -1.13644e-15 -1233.93 3.18917 );
        lowCpCoeffs  ( 3.21294 0.00112749 -5.75615e-07 1.31388e-09 -8.76855e-13 -1005.25 6.03474 ); }
    transport { As 1.67212e-06; Ts 170.672; }
}
H2O {
    specie { nMoles 1; molWeight 18.0153; }
    thermodynamics { Tlow 200; Thigh 5000; Tcommon 1000;
        highCpCoeffs ( 2.67215 0.00305629 -8.73026e-07 1.201e-10 -6.39162e-15 -29899.2 6.86282 );
        lowCpCoeffs  ( 3.38684 0.00347498 -6.3547e-06 6.96858e-09 -2.50659e-12 -30208.1 2.59023 ); }
    transport { As 1.67212e-06; Ts 170.672; }
}
C3H8 {
    specie { nMoles 1; molWeight 44.0962; }
    thermodynamics { Tlow 200; Thigh 5000; Tcommon 1000;
        highCpCoeffs ( 7.5252 0.0188904 -6.2832e-06 9.18935e-10 -4.81241e-14 -16464.5 -17.8439 );
        lowCpCoeffs  ( 0.93355 0.0264246 6.10597e-06 -2.19775e-08 9.51492e-12 -13958.5 19.2017 ); }
    transport { As 1.67212e-06; Ts 170.672; }
}
CO2 {
    specie { nMoles 1; molWeight 44.01; }
    thermodynamics { Tlow 200; Thigh 5000; Tcommon 1000;
        highCpCoeffs ( 4.45362 0.00314017 -1.27841e-06 2.394e-10 -1.66903e-14 -48967 -0.955396 );
        lowCpCoeffs  ( 2.27572 0.00992207 -1.04091e-05 6.86669e-09 -2.11728e-12 -48373.1 10.1885 ); }
    transport { As 1.67212e-06; Ts 170.672; }
}
N2 {
    specie { nMoles 1; molWeight 28.0134; }
    thermodynamics { Tlow 200; Thigh 5000; Tcommon 1000;
        highCpCoeffs ( 2.92664 0.00148798 -5.68476e-07 1.0097e-10 -6.75335e-15 -922.798 5.98053 );
        lowCpCoeffs  ( 3.29868 0.00140824 -3.96322e-06 5.64152e-09 -2.44486e-12 -1020.9 3.95037 ); }
    transport { As 1.67212e-06; Ts 170.672; }
}
"""

DICTS = {
    "system/fvSchemes": """FoamFile { version 2.0; format ascii; class dictionary; object fvSchemes; }
ddtSchemes { default Euler; }
gradSchemes { default Gauss linear; }
divSchemes {
    default none;
    div(phi,U) Gauss LUST grad(U);
    div(phi,k) Gauss limitedLinear 1;
    div(phi,Yi_h) Gauss multivariateSelection {
        O2 limitedLinear01 1; N2 limitedLinear01 1; C3H8 limitedLinear01 1;
        H2O limitedLinear01 1; CO2 limitedLinear01 1; h limitedLinear 1; };
    div(((rho*nuEff)*dev2(T(grad(U))))) Gauss linear;
    div(Ji,Ii_h) Gauss upwind;
}
laplacianSchemes { default Gauss linear uncorrected; }
interpolationSchemes { default linear; }
snGradSchemes { default uncorrected; }
""",
    "system/fvSolution": """FoamFile { version 2.0; format ascii; class dictionary; object fvSolution; }
solvers {
    "rho.*" { solver diagonal; }
    p_rgh { solver PCG; preconditioner DIC; tolerance 1e-6; relTol 0.01; }
    p_rghFinal { $p_rgh; relTol 0; }
    ph_rgh { $p_rgh; }
    "U.*" { solver PBiCGStab; preconditioner DILU; tolerance 1e-6; relTol 0; maxIter 50; }
    "(Yi|h|k).*" { $U; tolerance 1e-8; }
    Ii { solver PBiCGStab; tolerance 1e-4; relTol 0; }
    G  { solver PCG; preconditioner DIC; tolerance 1e-6; relTol 0; }
}
PIMPLE {
    momentumPredictor yes; nOuterCorrectors 1; nCorrectors 2;
    nNonOrthogonalCorrectors 0;
    hydrostaticInitialization yes; nHydrostaticCorrectors 3;
}
relaxationFactors { fields { ".*" 1; } }
""",
    "constant/g": """FoamFile { version 2.0; format ascii; class uniformDimensionedVectorField; object g; }
dimensions [0 1 -2 0 0 0 0];
value (0 -9.81 0);
""",
    "constant/pRef": """FoamFile { version 2.0; format ascii; class uniformDimensionedScalarField; object pRef; }
dimensions [1 -1 -2 0 0 0 0];
value 101325;
""",
    "constant/thermophysicalProperties": """FoamFile { version 2.0; format ascii; class dictionary; object thermophysicalProperties; }
thermoType {
    type hePsiThermo; mixture singleStepReactingMixture; transport sutherland;
    thermo janaf; energy sensibleEnthalpy; equationOfState perfectGas; specie specie;
}
inertSpecie N2;
fuel C3H8;
chemistryReader foamChemistryReader;
foamChemistryFile "$FOAM_CASE/constant/reactions";
foamChemistryThermoFile "$FOAM_CASE/constant/thermo.gas";
""",
    "constant/reactions": """species ( O2 H2O C3H8 CO2 N2 );
reactions {
    propaneReaction {
        type irreversibleinfiniteReaction;
        reaction "C3H8 + 5O2 + 18.8N2 = 3CO2 + 4H2O + 18.8N2";
    }
}
""",
    "constant/thermo.gas": THERMO_GAS,
    "constant/turbulenceProperties": """FoamFile { version 2.0; format ascii; class dictionary; object turbulenceProperties; }
simulationType LES;
LES {
    LESModel kEqn; delta cubeRootVol; turbulence on; printCoeffs off;
    kEqnCoeffs { C 0.03; Prt 1; Ck 0.094; Ce 1.048; }
    cubeRootVolCoeffs { deltaCoeff 1; }
}
""",
    "constant/combustionProperties": """FoamFile { version 2.0; format ascii; class dictionary; object combustionProperties; }
combustionModel eddyDissipationModel<psiThermoCombustion,gasHThermoPhysics>;
eddyDissipationModelCoeffs { semiImplicit no; C_EDC 4.0; C_Diff 0; C_Stiff 1; active on; }
""",
    "constant/radiationProperties": """FoamFile { version 2.0; format ascii; class dictionary; object radiationProperties; }
radiation on;
radiationModel fvDOM;
fvDOMCoeffs { nPhi 2; nTheta 2; convergence 1e-3; maxIter 1; }
solverFreq 10;
absorptionEmissionModel constRadFractionEmission;
constRadFractionEmissionCoeffs { EhrrCoeff 0.2; radScaling false; Ehrr1 0.2; Ehrr2 0.2; patch1 (burner); patch2 (burner); }
scatterModel constantScatter;
constantScatterCoeffs { sigma sigma [0 -1 0 0 0 0 0] 0; C C [0 0 0 0 0 0 0] 0; }
sootModel none;
""",
    "system/createPatchDict": """FoamFile { version 2.0; format ascii; class dictionary; object createPatchDict; }
pointSync false;
patches (
    { name burner; patchInfo { type patch; } constructFrom set; set burner; }
);
""",
    "system/createBafflesDict": """FoamFile { version 2.0; format ascii; class dictionary; object createBafflesDict; }
internalFacesOnly true;
baffles {
    roomWalls {
        type faceZone; zoneName roomWalls;
        patches {
            master { name walls_master; type wall; }
            slave  { name walls_slave;  type wall; }
        }
    }
}
""",
    "mesh.sh": """runApplication blockMesh
runApplication topoSet -dict system/topoSetDictBurner
runApplication createPatch -overwrite
runApplication topoSet -dict system/topoSetDictWalls
runApplication createBaffles -overwrite
""",
}


def _w(path: str, text: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _v(p) -> str:
    return "(" + " ".join(f"{float(x):.6g}" for x in p) + ")"


def _box(lo, hi) -> str:
    return f"box {_v(lo)} {_v(hi)};"


def write(root: str, h: float = 0.1, domain=((-2.0, 0.0, -2.0), (4.0, 3.0, 2.0)),
          room=(2.8, 2.18, 2.8), door=(0.74, 1.83), burner=0.3048, hrr_kw: float = 62.9,
          end_time: float = 100.0, control_dict=None) -> str:
    """Write the case into `root` (see the module's doc) and return it.
    `room` is (x, height, z), `door` (width, height), `burner` the burner's
    side, all in m; `control_dict` sets entries of system/controlDict."""
    (x0, y0, z0), (x1, y1, z1) = domain
    n = [round((b - a) / h) for a, b in zip(domain[0], domain[1])]
    if any(abs(k * h - (b - a)) > 1e-9 for k, a, b in zip(n, domain[0], domain[1])):
        raise ValueError(f"the domain is not a whole number of {h} m cells")

    def snap(v):
        return round(v / h) * h

    rx, ry, rz = snap(room[0] / 2), snap(room[1]), snap(room[2] / 2)
    dw, dh = snap(door[0] / 2), snap(door[1])
    e = 0.25 * h
    hb = burner / 2
    _w(f"{root}/constant/polyMesh/blockMeshDict",
       f"""FoamFile {{ version 2.0; format ascii; class dictionary; object blockMeshDict; }}
convertToMeters 1;
vertices (
    ({x0} {y0} {z0}) ({x1} {y0} {z0}) ({x1} {y1} {z0}) ({x0} {y1} {z0})
    ({x0} {y0} {z1}) ({x1} {y0} {z1}) ({x1} {y1} {z1}) ({x0} {y1} {z1})
);
blocks ( hex (0 1 2 3 4 5 6 7) ({n[0]} {n[1]} {n[2]}) simpleGrading (1 1 1) );
edges ();
boundary (
    top   {{ type patch; faces ( (3 7 6 2) ); }}
    sides {{ type patch; faces ( (0 4 7 3) (1 2 6 5) (0 3 2 1) (4 5 6 7) ); }}
    base  {{ type wall;  faces ( (0 1 5 4) ); }}
);
mergePatchPairs ();
""")
    _w(f"{root}/system/topoSetDictBurner",
       f"""FoamFile {{ version 2.0; format ascii; class dictionary; object topoSetDict; }}
actions (
    {{ name f0; type faceSet; action new; source patchToFace;
      sourceInfo {{ name base; }} }}
    {{ name f0; type faceSet; action subset; source boxToFace;
      sourceInfo {{ {_box((-hb, y0 - e, -hb), (hb, y0 + e, hb))} }} }}
    {{ name burner; type faceZoneSet; action new; source setToFaceZone;
      sourceInfo {{ faceSet f0; }} }}
);
""")
    # the room's faces: the back wall, the two side walls, the door wall
    # but its doorway, and the ceiling
    walls = [((-rx - e, y0, -rz), (-rx + e, ry, rz)),
             ((-rx, y0, -rz - e), (rx, ry, -rz + e)),
             ((-rx, y0, rz - e), (rx, ry, rz + e)),
             ((rx - e, y0, -rz), (rx + e, ry, -dw)),
             ((rx - e, y0, dw), (rx + e, ry, rz)),
             ((rx - e, dh, -dw), (rx + e, ry, dw)),
             ((-rx, ry - e, -rz), (rx, ry + e, rz))]
    acts = "\n".join(
        f"    {{ name w0; type faceSet; action {'new' if i == 0 else 'add'}; source boxToFace;\n"
        f"      sourceInfo {{ {_box(lo, hi)} }} }}" for i, (lo, hi) in enumerate(walls))
    _w(f"{root}/system/topoSetDictWalls",
       f"""FoamFile {{ version 2.0; format ascii; class dictionary; object topoSetDict; }}
actions (
{acts}
    {{ name roomWalls; type faceZoneSet; action new; source setToFaceZone;
      sourceInfo {{ faceSet w0; }} }}
);
""")
    cd = {"deltaT": 0.01, "writeControl": "adjustableRunTime", "writeInterval": 1}
    cd.update(control_dict or {})
    _w(f"{root}/system/controlDict",
       f"""FoamFile {{ version 2.0; format ascii; class dictionary; object controlDict; }}
application fireFoam;
startFrom startTime; startTime 0;
stopAt endTime; endTime {end_time};
deltaT {cd['deltaT']};
writeControl {cd['writeControl']}; writeInterval {cd['writeInterval']};
adjustTimeStep yes; maxCo 0.9; maxDeltaT 0.1;
runTimeModifiable no;
""")
    _w(f"{root}/constant/hRef",
       "FoamFile { version 2.0; format ascii; class uniformDimensionedScalarField; object hRef; }\n"
       f"dimensions [0 1 0 0 0 0 0];\nvalue {y1};\n")
    for rel, text in DICTS.items():
        _w(f"{root}/{rel}", text)
    _fields(root, hrr_kw * 1e3 / Q_FUEL)
    return root


def _fields(root: str, mdot: float):
    wall = {"U": "type noSlip;",
            "T": "type fixedValue;\n        value uniform 298.15;",
            "p_rgh": "type fixedFluxPressure;\n        value uniform 0;",
            "k": "type zeroGradient;",
            "O2": "type zeroGradient;", "C3H8": "type zeroGradient;",
            "Ydefault": "type zeroGradient;"}
    open_ = {"U": "type pressureInletOutletVelocity;\n        value uniform (0 0 0);",
             "T": "type inletOutlet;\n        inletValue uniform 298.15;\n        value uniform 298.15;",
             "p_rgh": "type prghTotalHydrostaticPressure;\n        value uniform 0;",
             "k": "type inletOutlet;\n        inletValue uniform 1e-4;\n        value uniform 1e-4;",
             "O2": "type inletOutlet;\n        inletValue uniform 0.23301;\n        value uniform 0.23301;",
             "C3H8": "type inletOutlet;\n        inletValue uniform 0;\n        value uniform 0;",
             "Ydefault": "type inletOutlet;\n        inletValue uniform 0;\n        value uniform 0;"}
    flux = "type totalFlowRateAdvectiveDiffusive;\n        massFluxFraction {0};\n        value uniform {0};"
    burner = {"U": f"type flowRateInletVelocity;\n        massFlowRate constant {mdot:.9g};\n"
                   "        value uniform (0 0 0);",
              "T": "type fixedValue;\n        value uniform 298.15;",
              "p_rgh": "type fixedFluxPressure;\n        value uniform 0;",
              "k": "type fixedValue;\n        value uniform 1e-4;",
              "O2": flux.format(0), "C3H8": flux.format(1), "Ydefault": flux.format(0)}
    kinds = {"top": open_, "sides": open_, "base": wall, "burner": burner,
             "walls_master": wall, "walls_slave": wall}
    specs = {f: {p: k[f] for p, k in kinds.items()} for f in open_}
    specs["p"] = {p: "type calculated;\n        value uniform 101325;" for p in kinds}
    for f in ("alphat", "nut"):
        specs[f] = {p: "type zeroGradient;" for p in kinds}
    specs["IDefault"] = {p: "type greyDiffusiveRadiation;\n        T T;\n        emissivityMode lookup;\n"
                            "        emissivity uniform 1;\n        value uniform 0;" for p in kinds}
    heads = {"U": ("volVectorField", "[0 1 -1 0 0 0 0]", "uniform (0 0 0)"),
             "T": ("volScalarField", "[0 0 0 1 0 0 0]", "uniform 298.15"),
             "p_rgh": ("volScalarField", "[1 -1 -2 0 0 0 0]", "uniform 0"),
             "p": ("volScalarField", "[1 -1 -2 0 0 0 0]", "uniform 101325"),
             "k": ("volScalarField", "[0 2 -2 0 0 0 0]", "uniform 1e-4"),
             "alphat": ("volScalarField", "[1 -1 -1 0 0 0 0]", "uniform 0"),
             "nut": ("volScalarField", "[0 2 -1 0 0 0 0]", "uniform 0"),
             "O2": ("volScalarField", "[0 0 0 0 0 0 0]", "uniform 0.23301"),
             "C3H8": ("volScalarField", "[0 0 0 0 0 0 0]", "uniform 0"),
             "Ydefault": ("volScalarField", "[0 0 0 0 0 0 0]", "uniform 0"),
             "IDefault": ("volScalarField", "[1 0 -3 0 0 0 0]", "uniform 0")}
    for name, (cls, dims, internal) in heads.items():
        body = "\n".join(f"    {p} {{\n        {s}\n    }}" for p, s in specs[name].items())
        _w(f"{root}/0/{name}",
           f"FoamFile {{ version 2.0; format ascii; class {cls}; object {name}; }}\n"
           f"dimensions {dims};\ninternalField {internal};\nboundaryField {{\n{body}\n}}\n")


if __name__ == "__main__":
    print(write(sys.argv[1], *(float(a) for a in sys.argv[2:3])))
