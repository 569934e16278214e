"""Traffic kinds: the generator and driver of each kind of traffic mix."""
