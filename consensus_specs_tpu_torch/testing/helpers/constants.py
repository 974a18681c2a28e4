"""Fork / preset name registry (reference: test/helpers/constants.py)."""

PHASE0 = "phase0"
ALTAIR = "altair"
BELLATRIX = "bellatrix"
CAPELLA = "capella"

# Experimental phases (not in ALL_PHASES)
SHARDING = "sharding"
CUSTODY_GAME = "custody_game"
DAS = "das"
EIP4844 = "eip4844"

ALL_PHASES = (PHASE0, ALTAIR, BELLATRIX, CAPELLA)
TESTGEN_FORKS = (PHASE0, ALTAIR, BELLATRIX)

FORKS_BEFORE_ALTAIR = (PHASE0,)
FORKS_BEFORE_BELLATRIX = (PHASE0, ALTAIR)
# experimental branches hang off bellatrix: capella-era state fields
# (withdrawals queue etc.) do not exist on them
FORKS_BEFORE_CAPELLA = (PHASE0, ALTAIR, BELLATRIX,
                        SHARDING, CUSTODY_GAME, DAS, EIP4844)

ALL_FORK_UPGRADES = {
    PHASE0: ALTAIR,
    ALTAIR: BELLATRIX,
    BELLATRIX: CAPELLA,
}
ALL_PRE_POST_FORKS = ALL_FORK_UPGRADES.items()
AFTER_BELLATRIX_UPGRADES = {
    k: v for k, v in ALL_FORK_UPGRADES.items() if k not in FORKS_BEFORE_ALTAIR
}
AFTER_BELLATRIX_PRE_POST_FORKS = AFTER_BELLATRIX_UPGRADES.items()

MAINNET = "mainnet"
MINIMAL = "minimal"
ALL_PRESETS = (MINIMAL, MAINNET)

MAX_UINT_64 = 2**64 - 1
