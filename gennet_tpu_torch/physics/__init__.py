"""GW signal physics for the template pipeline (PhenomD, PSD, whitening,
detector geometry, mass priors)."""
