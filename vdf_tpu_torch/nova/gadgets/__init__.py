"""In-circuit gadgets of the two-curve IVC's augmented circuit
(nova/augmented.py): the Poseidon sponge, native-field curve points,
non-native limbs, and the other curve's instances with their fold."""
