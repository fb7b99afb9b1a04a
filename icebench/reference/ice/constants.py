"""Physical and numerical constants (copy of cice_tpu/constants.py).

The constant sets used by CICE/Icepack (reference
cicecore/shared/ice_constants.F90; the column-physics constants are the
standard Icepack values published in the Icepack documentation). All are
plain Python floats, used at the working dtype of the tensors they meet.
"""

import math

# --- earth / orbital -------------------------------------------------------
omega = 7.292e-5          # angular velocity of earth (rad/s)
radius = 6.37e6           # earth radius (m)
gravit = 9.80616          # gravitational acceleration (m/s^2)
secday = 86400.0          # seconds per day
daycal_yr = 365.0         # days in a no-leap year

pi = math.pi
pih = 0.5 * math.pi
piq = 0.25 * math.pi
pi2 = 2.0 * math.pi
rad_to_deg = 180.0 / math.pi
deg_to_rad = math.pi / 180.0

# --- densities (kg/m^3) ----------------------------------------------------
rhoi = 917.0              # density of ice
rhos = 330.0              # density of snow
rhow = 1026.0             # density of seawater
rhofresh = 1000.0         # density of fresh water
rhoa_ref = 1.3            # reference air density (forcing fallback)

# --- thermodynamics --------------------------------------------------------
cp_air = 1005.0           # specific heat of air (J/kg/K)
cp_ice = 2106.0           # specific heat of fresh ice (J/kg/K)
cp_ocn = 4218.0           # specific heat of sea water (J/kg/K)
cp_wv = 1.81e3            # specific heat of water vapor (J/kg/K)
Lsub = 2.835e6            # latent heat of sublimation (J/kg)
Lvap = 2.501e6            # latent heat of vaporization (J/kg)
Lfresh = Lsub - Lvap      # latent heat of melting fresh ice (J/kg)
Tffresh = 273.15          # freezing temperature of fresh water (K)
TTTice = 5897.8           # ice surface saturated-vapor-pressure parameter (K)
qqqice = 11637800.0       # ice surface saturated-vapor-pressure parameter (kg/m^3)
TTTocn = 5107.4           # ocean surface vapor-pressure parameter (K)
qqqocn = 627572.4         # ocean surface vapor-pressure parameter (kg/m^3)
depressT = 0.054          # freezing-point depression per psu (deg/psu)
Tsmelt = 0.0              # melting temperature of snow top surface (C)
Timelt = 0.0              # melting temperature of ice top surface (C)
kice = 2.03               # thermal conductivity of fresh ice (W/m/deg)
ksno = 0.30               # thermal conductivity of snow (W/m/deg)
betak = 0.13              # conductivity salinity dependence (W/m/psu) [BL99 / MU71]
kimin = 0.10              # min conductivity of saline ice (W/m/deg)
hfrazilmin = 0.05         # min thickness of new frazil ice (m)
phi_init = 0.75           # initial liquid fraction of frazil (mushy)
dSin0_frazil = 3.0        # bulk salinity reduction of newly formed frazil (psu)
salt_loss = 0.4           # fraction of salt retained in zsalinity
min_salin = 0.1           # threshold for brine pocket presence (psu)
saltmax = 3.2             # max salinity, BL99 salinity profile (psu)
msal = 0.573              # liquidus slope parameters (Assur / linear_S)
nsal = 0.407
ustar_min = 0.005         # minimum friction velocity under ice (m/s)
ch_mixed = 0.006          # heat-transfer coefficient, ice-ocean (cpchr analog)
cprho = cp_ocn * rhow

# --- radiation -------------------------------------------------------------
stefan_boltzmann = 567.0e-10   # W/m^2/K^4
emissivity = 0.985             # longwave emissivity of snow/ice
albocn = 0.06                  # ocean albedo
snowpatch = 0.02               # snow patchiness parameter (m) [ccsm3 albedo]
awtvdr = 0.00318               # visible direct band weight
awtidr = 0.00182               # near-IR direct band weight
awtvdf = 0.63282               # visible diffuse band weight
awtidf = 0.36218               # near-IR diffuse band weight
kappav = 1.4                   # visible extinction coeff in ice (1/m)
hi_ssl = 0.050                 # ice surface scattering layer thickness (m)
hs_ssl = 0.040                 # snow surface scattering layer thickness (m)
i0vis = 0.70                   # fraction of penetrating visible solar radiation

# --- atmosphere boundary layer --------------------------------------------
zref = 10.0               # reference height for stability (m)
iceruf = 0.0005           # ice surface roughness (m)
vonkar = 0.40             # von Karman constant
zvir = 0.606              # rh2o/rair - 1.0
senscoef = 0.0012         # sensible heat transfer coefficient (constant scheme)
latncoef = 0.0015         # latent heat transfer coefficient (constant scheme)

# --- ocean -----------------------------------------------------------------
dragio = 0.00536          # ice-ocean drag coefficient
albocn_dir = albocn
Tocnfrz = -1.8            # freezing temp of seawater (C) for tfrz_option='minus1p8'
frzpnt = -1.8

# --- dynamics --------------------------------------------------------------
Pstar = 2.75e4            # ice strength parameter (N/m) [Hibler 79]
Cstar = 20.0              # ice strength exponential parameter
Cf = 17.0                 # ratio of ridging work to PE change [Rothrock 75]
u0 = 5e-5                 # residual velocity for seabed stress (m/s)
cosw = 1.0                # cos(ocean turning angle), angle = 0
sinw = 0.0                # sin(ocean turning angle)
dragw = dragio * rhow

# --- numerical -------------------------------------------------------------
puny = 1.0e-11
hs_min = 1.0e-4            # min snow depth for the conduction solve to
                           # carry snow layers (icepack hs_min parameter;
                           # thinner snow is a massless skin — without
                           # this the 1/hslyr solve coefficients at
                           # hs ~ 1e-10 overflow f32 and NaN the column)
eps04 = 1.0e-4
eps13 = 1.0e-13
eps16 = 1.0e-16
bignum = 1.0e30
spval = 1.0e30

# --- conversion ------------------------------------------------------------
cm_to_m = 0.01
m_to_cm = 100.0
m2_to_km2 = 1.0e-6
kg_to_g = 1000.0
mps_to_cmpdy = 8.64e6

# --- field location / type attributes (staggered-grid halo semantics) ------
# reference: ice_constants.F90:95-110
FIELD_LOC_CENTER = 1
FIELD_LOC_NECORNER = 2
FIELD_LOC_NFACE = 3
FIELD_LOC_EFACE = 4

FIELD_TYPE_SCALAR = 1
FIELD_TYPE_VECTOR = 2
FIELD_TYPE_ANGLE = 3
kbrine = 0.5              # thermal conductivity of brine (W/m/deg)
