"""Physical constants and conversion factors.

Mirrors the capability of the reference's constants module
(Julia reference src/constants.jl:1-26): SI constants used by the kinetic
calculators, plus the ASE-compatible constant set used by the TST
thermochemistry pipeline so that rate constants computed here agree with
ASE's ``IdealGasThermo`` conventions.
"""

# Physical constants (SI)
R = 8.314462618          # Gas constant (J/K/mol)
N_A = 6.02214076e23      # Avogadro constant (/mol)
k_b = 1.380649e-23       # Boltzmann constant (J/K)
h = 6.626070e-34         # Planck constant (J s)

# Conversion factors
kcal_to_J = 4183.9954
eV_to_kcal_per_mol = 23.061
amu_to_kg = 1.6605390666e-27
eV_to_J_per_mol = eV_to_kcal_per_mol * kcal_to_J  # ~96485 J/mol per eV
Ang_to_dm = 1e-9

# ASE-compatible constants (values match ase.units so thermochemistry
# cross-checks against ASE's IdealGasThermo are bit-comparable).
kB = 8.617330337217213e-5    # Boltzmann constant (eV/K)
amu = 1.66053904e-27         # 1 Da (kg)
k = 1.38064852e-23           # Boltzmann constant (J/K), ASE value
hplanck = 6.62607004e-34     # Planck constant (J s), ASE value
ref_P = 1e5                  # Reference pressure (Pa)
hbar = 1.0545718001391127e-34  # Reduced Planck constant (J s)
m = 1e10                     # Metres in 1 Angstrom (inverse: Ang per m)
e = 1.6021766208e-19         # Electron charge (C)
J = 6.241509125883258e18     # eV in 1 J
mol = 6.022140857e23         # Avogadro's number, ASE value
