from .gait import (FLY, MAX_EVENTS, MODE_NAMES, STANCE, ModeSchedule,
                   contact_flags_from_mode, mode_at_time,
                   mode_from_contact_flags, mode_schedule_from_lists)
