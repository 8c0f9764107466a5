"""The benchmark's plain reference: the answers a correct store gives,
worked out again from the seeded columns and the requests' parameters in
plain PyTorch (float64 unless a control asks for less). It imports
nothing of the program."""
