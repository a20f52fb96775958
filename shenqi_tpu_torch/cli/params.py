"""Parameter declarations for the gadget/genic CLIs (params.cpp analog).

Declares the reference's runtime parameters with the same names,
defaults and help strings (gadget/params.cpp, genic/params.cpp) so that
reference parameter files drive this framework unmodified.  Parameters
for physics not yet implemented are declared (accepted and validated)
and their consumers check feature availability at use time.

A copy of shenqi_tpu/cli/params.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package; tests/test_torch_genic_io.py pins it.
"""

from __future__ import annotations

from ..utils.config import ParameterSet, REQUIRED, OPTIONAL


def gadget_params() -> ParameterSet:
    ps = ParameterSet()
    d, i, s, e = (ps.declare_double, ps.declare_int, ps.declare_string,
                  ps.declare_enum)
    # files & control
    s("InitCondFile", REQUIRED, None, "Path to the Initial Condition File")
    s("OutputDir", OPTIONAL, "output", "Output directory")
    s("OutputList", OPTIONAL, "", "Comma-separated output scale factors")
    s("SnapshotFileBase", OPTIONAL, "PART", "Snapshot base name")
    s("FOFFileBase", OPTIONAL, "PIG", "Halo catalog base name")
    s("EnergyFile", OPTIONAL, "energy.txt", "Energy statistics file")
    s("CpuFile", OPTIONAL, "cpu.txt", "Walltime statistics file")
    d("TimeLimitCPU", OPTIONAL, 86400, "CPU time limit in seconds")
    d("TimeMax", OPTIONAL, 1.0, "End scale factor")
    d("AutoSnapshotTime", OPTIONAL, 0, "Wall seconds between checkpoints")
    i("SnapshotWithFOF", OPTIONAL, 0, "Run FOF when writing snapshots")
    d("NoSnapshotUntilTime", OPTIONAL, 0, "Suppress snapshots before a=")
    # cosmology
    d("Omega0", REQUIRED, None, "Total matter density at z=0")
    d("OmegaBaryon", OPTIONAL, -1, "Baryon density at z=0 (IC default)")
    d("OmegaLambda", OPTIONAL, -1, "Vacuum energy (IC default)")
    d("HubbleParam", OPTIONAL, -1, "Little h (IC default)")
    d("CMBTemperature", OPTIONAL, 2.7255, "CMB temperature at z=0")
    i("RadiationOn", OPTIONAL, 1, "Include radiation in the background")
    d("Omega_fld", OPTIONAL, 0, "Dark energy fluid density")
    d("w0_fld", OPTIONAL, -1.0, "DE equation of state")
    d("wa_fld", OPTIONAL, 0.0, "DE EOS evolution")
    d("Omega_ur", OPTIONAL, 0.0, "Extra radiation density")
    d("MNue", OPTIONAL, 0, "Neutrino mass 1 (eV)")
    d("MNum", OPTIONAL, 0, "Neutrino mass 2 (eV)")
    d("MNut", OPTIONAL, 0, "Neutrino mass 3 (eV)")
    i("MassiveNuLinRespOn", OPTIONAL, 0, "Massive-nu linear response")
    i("HybridNeutrinosOn", OPTIONAL, 0, "Hybrid particle/analytic nus")
    d("Vcrit", OPTIONAL, 500., "Hybrid nu critical velocity")
    d("NuPartTime", OPTIONAL, 0.3333333, "Hybrid nu particle switch-on")
    # units
    d("UnitLength_in_cm", OPTIONAL, 3.085678e21, "kpc/h default")
    d("UnitMass_in_g", OPTIONAL, 1.989e43, "1e10 Msun/h default")
    d("UnitVelocity_in_cm_per_s", OPTIONAL, 1e5, "km/s default")
    # gravity
    d("ErrTolForceAcc", OPTIONAL, 0.002, "Tree force accuracy")
    d("BHOpeningAngle", OPTIONAL, 0.175, "Barnes-Hut opening angle")
    d("MaxBHOpeningAngle", OPTIONAL, 0.9, "Max BH angle with rel-acc")
    d("TreeRcut", OPTIONAL, 6, "Tree walk cutoff in mesh cells")
    i("TreeUseBH", OPTIONAL, 2, "1: BH criterion; 2: first step only")
    d("Asmth", OPTIONAL, 1.5, "Long/short force split (mesh cells)")
    i("Nmesh", OPTIONAL, -1, "PM mesh size (default 2x cbrt(N))")
    e("ShortRangeForceWindowType", {"exact": 0, "erfc": 1}, OPTIONAL,
      "exact", "Short-range window: calibrated table or erfc")
    d("FractionalGravitySoftening", OPTIONAL, 1.0 / 30,
      "Softening as fraction of mean separation")
    i("SplitGravityTimestepsOn", OPTIONAL, 1, "Hierarchical gravity")
    i("HierarchicalGravity", OPTIONAL, 0, "Alias of split timesteps")
    # timesteps
    d("ErrTolIntAccuracy", OPTIONAL, 0.02, "Timestep accuracy eta")
    d("MaxSizeTimestep", OPTIONAL, 0.1, "Max PM dloga")
    d("MinSizeTimestep", OPTIONAL, 0, "Min dloga")
    d("MaxRMSDisplacementFac", OPTIONAL, 0.2, "PM step criterion")
    d("CourantFac", OPTIONAL, 0.15, "Courant factor")
    i("ForceEqualTimesteps", OPTIONAL, 0, "Single global timestep")
    i("FastParticleType", OPTIONAL, 2, "Type ignored for PM step")
    d("MaxGasVel", OPTIONAL, 3e5, "Gas velocity cap (km/s)")
    i("MaxDomainTimeBinDepth", OPTIONAL, 8, "Full decomposition cadence")
    # memory
    d("PartAllocFactor", OPTIONAL, 1.5, "Particle headroom factor")
    d("SlotsIncreaseFactor", OPTIONAL, 0.01, "Slot headroom for SF")
    # SPH
    i("HydroOn", OPTIONAL, 1, "Enable hydro")
    i("DensityOn", OPTIONAL, 1, "Enable density")
    i("DensityIndependentSphOn", OPTIONAL, 1, "Pressure-entropy SPH")
    d("DensityResolutionEta", OPTIONAL, 1.0, "Neighbor number eta")
    d("MaxNumNgbDeviation", OPTIONAL, 0.5, "Neighbor count tolerance")
    d("ArtBulkViscConst", OPTIONAL, 0.75, "Artificial viscosity")
    d("DensityContrastLimit", OPTIONAL, 100, "Grad-h contrast limit")
    e("DensityKernelType", {"cubic": 0, "quintic": 1, "quartic": 2},
      OPTIONAL, "quintic", "SPH kernel")
    d("MinGasTemp", OPTIONAL, 5, "Temperature floor (K)")
    d("InitGasTemp", OPTIONAL, -1, "Initial gas temperature")
    i("BlackHoleOn", REQUIRED, None, "Black holes master switch")
    i("StarformationOn", REQUIRED, None, "Star formation master switch")
    i("CoolingOn", REQUIRED, None, "Cooling master switch")
    i("WindOn", REQUIRED, None, "Winds master switch")
    i("MetalReturnOn", REQUIRED, None, "Metal return master switch")
    # cooling
    s("TreeCoolFile", OPTIONAL, "", "UV background table")
    s("FileWithTransferFunction", OPTIONAL, "",
      "CLASS transfer table (neutrino linear-response IC ratio)")
    s("MetalCoolFile", OPTIONAL, "", "Metal cooling table")
    s("UVFluctuationFile", OPTIONAL, "", "Patchy reionization table")
    e("CoolingRates", {"KWH92": 0, "Cen92": 1, "Sherwood": 2},
      OPTIONAL, "Sherwood", "Recombination rate fits")
    e("RecombRates", {"Verner96": 0, "Cen92": 1}, OPTIONAL, "Verner96",
      "Recombination rates")
    i("SelfShieldingOn", OPTIONAL, 1, "Self-shielding correction")
    d("PhotoIonizeFactor", OPTIONAL, 1, "UVB amplitude factor")
    i("PhotoIonizationOn", OPTIONAL, 1, "Photoionization on")
    d("UVRedshiftThreshold", OPTIONAL, -1, "UVB on after this z")
    d("HydrogenHeatAmp", OPTIONAL, 1., "H heating amplitude")
    d("HeliumHeatAmp", OPTIONAL, 1., "He heating amplitude")
    # star formation
    e("StarformationCriterion", {"density": 1, "h2": 3},
      OPTIONAL, "density", "SF criterion")
    d("CritOverDensity", OPTIONAL, 57.7, "SF overdensity threshold")
    i("BHFeedbackUseTcool", OPTIONAL, 1,
      "Relax hot eEOS gas on the cooling time: 1 = BH-heated or "
      "u>5e6, 3 = all eEOS gas (params.cpp:258)")
    d("CritPhysDensity", OPTIONAL, 0, "SF physical density (H/cm^3)")
    d("FactorSN", OPTIONAL, 0.1, "eEOS SN mass fraction beta")
    d("FactorEVP", OPTIONAL, 1000, "eEOS evaporation factor A0")
    d("TempSupernova", OPTIONAL, 1e8, "eEOS SN temperature")
    d("TempClouds", OPTIONAL, 1000, "eEOS cloud temperature")
    d("MaxSfrTimescale", OPTIONAL, 1.5, "SF timescale at threshold")
    d("Generations", OPTIONAL, 4, "Stars spawned per gas particle")
    d("QuickLymanAlphaProbability", OPTIONAL, 0,
      "Instant star conversion probability")
    # winds
    e("WindModel", {"subgrid": 1, "decouple": 2, "halo": 4,
                    "fixedefficiency": 8, "sh03": 11, "vs08": 8,
                    "ofjt10": 6, "isotropic": 512}, OPTIONAL,
      "ofjt10", "Wind model flags (winds.h values)")
    d("WindEfficiency", OPTIONAL, 2.0, "SH03 wind mass loading")
    d("WindEnergyFraction", OPTIONAL, 1.0, "Wind energy fraction")
    d("WindSigma0", OPTIONAL, 353, "VS08 velocity scale (km/s)")
    d("WindSpeedFactor", OPTIONAL, 3.7, "VS08 speed factor")
    d("WindFreeTravelLength", OPTIONAL, 20, "Decoupling length (kpc)")
    d("WindFreeTravelDensFac", OPTIONAL, 0.1, "Recoupling density")
    d("MinWindVelocity", OPTIONAL, 0, "Minimum wind velocity")
    d("WindThermalFactor", OPTIONAL, 0, "Thermal wind fraction")
    # black holes
    d("BlackHoleAccretionFactor", OPTIONAL, 100, "Bondi factor alpha")
    d("BlackHoleEddingtonFactor", OPTIONAL, 2.1, "Eddington cap")
    d("SeedBlackHoleMass", OPTIONAL, 2e-5,
      "Seed BH subgrid mass (params.cpp:190 default)")
    d("MinFoFMassForNewSeed", OPTIONAL, 2, "Halo mass for BH seed")
    d("MinMStarForNewSeed", OPTIONAL, 5e-4, "Stellar mass for seed")
    d("TimeBetweenSeedingSearch", OPTIONAL, 1.04,
      "Scale-factor ratio between BH seeding FOF searches "
      "(params.cpp:182 default)")
    d("BlackHoleNgbFactor", OPTIONAL, 2, "BH neighbor factor")
    d("BlackHoleMaxAccretionRadius", OPTIONAL, 99999., "Accretion radius")
    d("BlackHoleFeedbackFactor", OPTIONAL, 0.05, "Feedback efficiency")
    d("BlackHoleFeedbackRadius", OPTIONAL, 0, "Feedback radius")
    i("BH_DynFrictionMethod", OPTIONAL, 1, "Dynamic friction source")
    i("BH_DFBoostFactor", OPTIONAL, 1, "DF boost")
    d("BH_DFbmax", OPTIONAL, 20., "DF max impact parameter")
    i("BH_DRAG", OPTIONAL, 1, "BH drag")
    d("SeedBHDynMass", OPTIONAL, -1, "Seed dynamic mass")
    i("MergeGravBound", OPTIONAL, 1, "Require bound BH mergers")
    i("WriteBlackHoleDetails", OPTIONAL, 1, "Per-BH detail logs")
    # FOF
    d("FOFHaloLinkingLength", OPTIONAL, 0.2, "FOF linking length")
    i("FOFHaloMinLength", OPTIONAL, 32, "Minimum halo length")
    i("FOFSaveParticles", OPTIONAL, 1, "Save halo member particles")
    # misc
    i("RandomSeed", OPTIONAL, 42, "RNG seed")
    # reference default is 1 (params.cpp), but our snapshot path does
    # not yet produce a Potential block; default 0 so the paramset
    # reflects actual behavior rather than silently ignoring the flag
    i("OutputPotential", OPTIONAL, 0, "Save gravitational potential")
    i("OutputTimebins", OPTIONAL, 0, "Save timebins in snapshots")
    i("ShowBacktrace", OPTIONAL, 1, "Backtrace on crash")
    d("RandomParticleOffset", OPTIONAL, 8,
      "Random box shift in units of mean separation")
    i("PartiallyInitializedSPHOn", OPTIONAL, 0, "Relaxed IC check")
    i("HeliumReionizationOn", OPTIONAL, 0, "QSO helium reionization")
    i("QSOLightupOn", OPTIONAL, 0, "Alias: QSO helium reionization")
    s("ReionHistFile", OPTIONAL, "", "HeIII reionization history")
    d("QSOMinMass", OPTIONAL, 100., "QSO candidate min halo mass")
    d("QSOMaxMass", OPTIONAL, 1000., "QSO candidate max halo mass")
    d("QSOMeanBubble", OPTIONAL, 20000., "Mean HeIII bubble radius")
    d("QSOVarBubble", OPTIONAL, 0., "HeIII bubble radius variance")
    s("MetalYieldDir", OPTIONAL, "", "AGB/SNII yield table dir "
      "(default: the bundled data_yields/)")
    i("ExcursionSetReionOn", OPTIONAL, 0, "Excursion-set reionization")
    s("J21CoeffFile", OPTIONAL, "", "J21->rates coefficient table")
    d("ExcursionSetZStop", OPTIONAL, 5., "Excursion-set stop redshift")
    d("AlphaUV", OPTIONAL, 3., "UV spectral slope for J21 rates")
    i("UVBGdim", OPTIONAL, 64, "Excursion-set grid size")
    d("ReionRBubbleMax", OPTIONAL, 20340., "Max filter radius")
    d("ReionRBubbleMin", OPTIONAL, 406.8, "Min filter radius")
    d("ReionDeltaRFactor", OPTIONAL, 1.1, "Filter ladder ratio")
    d("ReionNionPhotPerBary", OPTIONAL, 4000., "Ionizing photons/baryon")
    d("EscapeFractionNorm", OPTIONAL, 0.2, "fesc at 1e10 Msun/h")
    d("EscapeFractionScaling", OPTIONAL, 0.5, "fesc mass slope")
    i("ReionUseParticleSFR", OPTIONAL, 0, "Use SFR grid for J21")
    d("ReionSFRTimescale", OPTIONAL, 0.1, "Star age / hubble time")
    i("ReionFilterType", OPTIONAL, 0, "0 tophat,1 sharp-k,2 gauss")
    i("RtoMFilterType", OPTIONAL, 0, "0 tophat,1 gaussian")
    d("ReionGammaHaloBias", OPTIONAL, 2.0, "Halo bias for J21")
    d("UVBGTimestep", OPTIONAL, 10., "Myr between UVBG calculations")
    d("ExcursionSetZStart", OPTIONAL, 25., "Excursion-set start z")
    # --- remaining reference params accepted for paramfile
    # compatibility (gadget/params.cpp names + defaults); consumers
    # check availability at use time, hardcoded-default behaviors
    # match the declared defaults ---
    i("OutputEnergyDebug", OPTIONAL, 0, "Energy debug statistics")
    s("PlaneOutputList", OPTIONAL, "", "Plane output scale factors")
    i("PlaneMassiveNuCorrection", OPTIONAL, 1, "Nu correction planes")
    i("PlaneDoubleOut", OPTIONAL, 0, "float64 FITS planes")
    i("OutputHeliumFractions", OPTIONAL, 0, "He ionic fractions out")
    i("OutputDebugFields", OPTIONAL, 0, "Debug snapshot fields")
    d("MinGasHsmlFractional", OPTIONAL, 0, "Min hsml / softening")
    d("HydroCostFactor", OPTIONAL, 1, "Unused (reference too)")
    i("BytesPerFile", OPTIONAL, 512 * 1024 * 1024, "Min bytes/file")
    d("HIReionTemp", OPTIONAL, 0, "HI reionization temp boost")
    i("TreeGravOn", OPTIONAL, 1, "Enables tree gravity")
    d("PairwiseActiveFraction", OPTIONAL, 0, "Pairwise if few active")
    d("GravitySoftening", OPTIONAL, 1.0 / 30,
      "Softening in mean DM separations (params.cpp:161; alias of "
      "FractionalGravitySoftening)")
    i("ParticlesAlwaysSorted", OPTIONAL, 0, "Peano-sort after exch")
    i("FOFPrimaryLinkTypes", OPTIONAL, 2, "2^type FOF primaries")
    i("FOFSecondaryLinkTypes", OPTIONAL, 1 + 16 + 32,
      "2^type FOF secondary attach")
    d("MaxSeedBlackHoleMass", OPTIONAL, 0, "Power-law seed cap")
    d("SeedBlackHoleMassIndex", OPTIONAL, -2, "Seed mass power law")
    i("BlackHoleKineticOn", OPTIONAL, 0, "AGN kinetic feedback")
    d("BHKE_EddingtonThrFactor", OPTIONAL, 0.05, "Kinetic Edd thr")
    d("BHKE_EddingtonMFactor", OPTIONAL, 0.002, "Kinetic Edd Mfac")
    d("BHKE_EddingtonMPivot", OPTIONAL, 0.05, "Kinetic Edd pivot")
    d("BHKE_EddingtonMIndex", OPTIONAL, 2, "Kinetic Edd index")
    d("BHKE_EffRhoFactor", OPTIONAL, 0.05, "Kinetic eff rho factor")
    d("BHKE_EffCap", OPTIONAL, 0.05, "Kinetic efficiency cap")
    d("BHKE_InjEnergyThr", OPTIONAL, 5, "Kinetic injection thresh")
    d("BlackHoleFeedbackRadiusMaxPhys", OPTIONAL, 0,
      "Unused (reference too)")
    i("MaxBlackHoleDetails", OPTIONAL, 50, "Max GB of BH details")
    s("BlackHoleFeedbackMethod", OPTIONAL, "spline, mass",
      "Unused (reference too)")
    i("BoostSFDenseGas", OPTIONAL, 1, "Shorter tsfr for dense gas")
    d("BoostSFOverDenseFactor", OPTIONAL, 1000,
      "Overdensity (vs SF threshold) for the SF boost")
    d("MaxWindFreeTravelTime", OPTIONAL, 60,
      "Max wind decoupled time (Myr)")
    d("QuickLymanAlphaTempThresh", OPTIONAL, 1e5,
      "QLA SF temperature threshold")
    i("HeliumHeatOn", OPTIONAL, 0, "He reion extra heating")
    d("HeliumHeatThresh", OPTIONAL, 10, "He heat overdensity thr")
    d("HeliumHeatExp", OPTIONAL, 0, "He heat density exponent")
    d("QSOHeIIIReionFinishFrac", OPTIONAL, 0.995,
      "HeIII fraction triggering flash finish")
    d("MetalsSn1aN0", OPTIONAL, 1.3e-3, "SN1a per Msun")
    d("MetalsMaxNgbDeviation", OPTIONAL, 5.,
      "Metal-return ngb tolerance")
    i("MetalsSPHWeighting", OPTIONAL, 1, "Volume-weighted return")
    i("LightconeOn", OPTIONAL, 0, "Lightcone output")
    i("WritePlaneOn", OPTIONAL, 0, "Lensing plane output")
    s("OutputPlaneList", OPTIONAL, "", "Plane output times")
    i("PlaneResolution", OPTIONAL, 256, "Plane grid size")
    d("PlaneThickness", OPTIONAL, 0., "Plane slab thickness")
    s("PlaneCutPoints", OPTIONAL, "", "Comma-separated cut points")
    s("PlaneNormals", OPTIONAL, "0,1,2", "Comma-separated normals")
    d("MeanSeparationScale", OPTIONAL, 1, "unused compat")
    i("DomainOverDecompositionFactor", OPTIONAL, -1, "compat")
    i("DomainUseGlobalSorting", OPTIONAL, 1, "compat")
    d("TopNodeAllocFactor", OPTIONAL, 0.5, "compat")
    d("ImportBufferBoost", OPTIONAL, 2., "compat")
    i("UseGPU", OPTIONAL, 1, "compat: accelerator on (always on TPU)")
    d("GravitySofteningGas", OPTIONAL, 0, "adaptive gas softening")
    i("MetalCoolingOn", OPTIONAL, 0, "metal cooling")
    i("HIIRegionOn", OPTIONAL, 0, "compat")
    i("WindIsotropyOn", OPTIONAL, 0, "compat")
    d("BlackHoleKineticEddingtonFactor", OPTIONAL, 0.05, "compat")
    i("BlackHoleRepositionEnabled", OPTIONAL, 0, "compat")
    return ps


def genic_params() -> ParameterSet:
    ps = ParameterSet()
    d, i, s = ps.declare_double, ps.declare_int, ps.declare_string
    s("OutputDir", REQUIRED, None, "IC output directory")
    s("FileBase", REQUIRED, None, "IC file base name")
    i("Ngrid", REQUIRED, None, "Particles per side")
    i("NgridGas", OPTIONAL, -1, "Gas particles per side")
    i("Nmesh", OPTIONAL, -1, "FFT mesh (default Ngrid)")
    d("BoxSize", REQUIRED, None, "Box size (internal units)")
    d("Omega0", REQUIRED, None, "Total matter density")
    d("OmegaBaryon", REQUIRED, None, "Baryon density")
    d("OmegaLambda", REQUIRED, None, "Vacuum energy")
    d("HubbleParam", REQUIRED, None, "Little h")
    i("ProduceGas", OPTIONAL, 0, "Generate gas particles")
    d("Redshift", OPTIONAL, 99, "Starting redshift")
    i("Seed", REQUIRED, None, "Gaussian field seed")
    i("UnitaryAmplitude", OPTIONAL, 0, "|g|=1 modes")
    i("InvertPhase", OPTIONAL, 0, "Paired sim phase flip")
    i("DifferentTransferFunctions", OPTIONAL, 1,
      "Per-species transfer functions")
    i("ScaleDepVelocity", OPTIONAL, -1, "Scale-dependent growth")
    s("FileWithInputSpectrum", REQUIRED, None, "P(k) table path")
    s("FileWithTransferFunction", OPTIONAL, "", "CLASS transfer table")
    d("Sigma8", OPTIONAL, -1, "Normalize to sigma8 at z=0")
    d("InputPowerRedshift", OPTIONAL, -1,
      "Redshift of the input table (-1: at starting z)")
    d("PrimordialIndex", OPTIONAL, 0.971, "Spectral tilt for EH")
    d("PrimordialAmp", OPTIONAL, 2.215e-9, "compat")
    d("PrimordialRunning", OPTIONAL, 0, "compat")
    i("WhichSpectrum", OPTIONAL, 2, "2: tabulated, 1: EH")
    d("MaxMemSizePerNode", OPTIONAL, 0.6, "compat")
    d("CMBTemperature", OPTIONAL, 2.7255, "CMB temperature")
    i("RadiationOn", OPTIONAL, 1, "Radiation in background")
    i("UsePeculiarVelocity", OPTIONAL, 0, "FastPM velocity convention")
    d("MNue", OPTIONAL, 0, "Neutrino mass 1")
    d("MNum", OPTIONAL, 0, "Neutrino mass 2")
    d("MNut", OPTIONAL, 0, "Neutrino mass 3")
    d("MWDM_therm", OPTIONAL, 0, "WDM thermal mass")
    i("NgridNu", OPTIONAL, 0,
      "Neutrino particles per side (0 = no nu particles; "
      "genic/params.cpp:159)")
    d("Max_nuvel", OPTIONAL, 5000, "Max nu thermal velocity")
    i("MakeGlassGas", OPTIONAL, -1, "Glass gas pre-IC")
    i("MakeGlassCDM", OPTIONAL, 0, "Glass CDM pre-IC")
    d("UnitLength_in_cm", OPTIONAL, 3.085678e21, "kpc/h")
    d("UnitMass_in_g", OPTIONAL, 1.989e43, "1e10 Msun/h")
    d("UnitVelocity_in_cm_per_s", OPTIONAL, 1e5, "km/s")
    i("NumPartPerFile", OPTIONAL, 1024 * 1024 * 128, "compat")
    i("NumWriters", OPTIONAL, 0, "compat")
    i("SavePrePos", OPTIONAL, 0, "Save pre-displacement positions")
    return ps
