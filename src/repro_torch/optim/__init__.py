"""AdamW, its learning-rate schedules and int8 gradient compression."""
