"""CPU tests of the benchmark; the card tests skip without a card."""
