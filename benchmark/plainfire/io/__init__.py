from .foamdict import FoamDict, Dimensions, parse_file, parse_string, tokenize
from .fields import FieldFile, read_field_file, write_field_file
from .casedir import Case
