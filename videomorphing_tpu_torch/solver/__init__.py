"""The halfway-domain correspondence solver: energy, descent, coarse to fine."""
