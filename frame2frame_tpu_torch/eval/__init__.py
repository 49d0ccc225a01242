from . import test
from .aug import test_x8
from .chunks import chunk, extract_chunks_config
