"""One runner a kind of traffic; a mix is a data file under ``traffic/``."""
