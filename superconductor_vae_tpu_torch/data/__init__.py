from .pipeline import composition_slots, parse_formula_composition, read_csv_rows
