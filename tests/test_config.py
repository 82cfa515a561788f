"""Config system tests (mirrors reference tests/test_config.cpp: YAML
parse/defaults/partial override, enum parsing, fatal validation vs
warn-and-clamp paths, preset loading)."""

import numpy as np
import pytest

from fastdem_tpu.config.config import (
    Config,
    EstimationType,
    MappingMode,
    SensorType,
    load_config,
    parse_config,
    parse_postprocess,
    validate,
)


class TestDefaults:
    def test_default_values(self):
        cfg = Config()
        assert cfg.mapping.mode == MappingMode.LOCAL
        assert cfg.mapping.estimation_type == EstimationType.KALMAN
        assert cfg.mapping.kalman.min_variance == pytest.approx(0.0001)
        assert cfg.mapping.kalman.max_variance == pytest.approx(0.01)
        assert cfg.mapping.p2.dn2 == pytest.approx(0.50)
        assert cfg.mapping.p2.elevation_marker == 3
        assert cfg.sensor_model.type == SensorType.LIDAR
        assert cfg.sensor_model.lidar.range_noise == pytest.approx(0.02)
        assert not cfg.raycasting.enabled
        assert cfg.raycasting.clear_threshold == pytest.approx(-1.0)

    def test_empty_yaml_gives_defaults(self):
        cfg = parse_config({})
        assert cfg.mapping.kalman.process_noise == 0.0


class TestParsing:
    def test_partial_override(self):
        cfg = parse_config(
            {"mapping": {"kalman": {"max_variance": 0.5}}}
        )
        assert cfg.mapping.kalman.max_variance == pytest.approx(0.5)
        assert cfg.mapping.kalman.min_variance == pytest.approx(0.0001)

    def test_enum_parsing(self):
        cfg = parse_config(
            {
                "mapping": {"mode": "global", "type": "p2_quantile"},
                "sensor_model": {"type": "rgbd"},
            }
        )
        assert cfg.mapping.mode == MappingMode.GLOBAL
        assert cfg.mapping.estimation_type == EstimationType.P2_QUANTILE
        assert cfg.sensor_model.type == SensorType.RGBD

    def test_enum_aliases(self):
        assert (
            parse_config({"sensor_model": {"type": "laser"}}).sensor_model.type
            == SensorType.LIDAR
        )
        assert (
            parse_config({"sensor_model": {"type": "none"}}).sensor_model.type
            == SensorType.CONSTANT
        )

    def test_unknown_enum_warns_default(self):
        # Unknown strings warn and fall back (config_fastdem.cpp:33-55).
        cfg = parse_config({"mapping": {"type": "bogus"}})
        assert cfg.mapping.estimation_type == EstimationType.KALMAN
        cfg = parse_config({"mapping": {"mode": "bogus"}})
        assert cfg.mapping.mode == MappingMode.LOCAL

    def test_point_filter_and_raycasting(self):
        cfg = parse_config(
            {
                "point_filter": {"z_min": -2.0, "range_max": 30.0},
                "raycasting": {"enabled": True, "log_odds_ghost": 0.3},
            }
        )
        assert cfg.point_filter.z_min == pytest.approx(-2.0)
        assert cfg.point_filter.range_max == pytest.approx(30.0)
        assert cfg.raycasting.enabled
        assert cfg.raycasting.log_odds_ghost == pytest.approx(0.3)

    def test_voxel_count_mode_key(self):
        # Extension key: parsed, and clamped to "exact" when invalid.
        cfg = parse_config(
            {"raycasting": {"enabled": True, "voxel_count_mode": "span"}}
        )
        assert cfg.raycasting.voxel_count_mode == "span"
        cfg2 = parse_config(
            {"raycasting": {"enabled": True, "voxel_count_mode": "bogus"}}
        )
        assert cfg2.raycasting.voxel_count_mode == "exact"

    def test_retired_polar_field_impl_key_warns_once(self, caplog):
        """Configs written for the removed polar-field kernel still load:
        the key is ignored with one warning."""
        with caplog.at_level("WARNING", logger="fastdem_tpu.config"):
            cfg = parse_config(
                {"raycasting": {"enabled": True, "polar_field_impl": "pallas",
                                "range_bin_factor": 0.5}}
            )
        msgs = [r.message for r in caplog.records
                if "polar_field_impl" in r.message]
        assert len(msgs) == 1 and "retired" in msgs[0]
        assert cfg.raycasting.range_bin_factor == pytest.approx(0.5)
        assert not hasattr(cfg.raycasting, "polar_field_impl")


class TestValidation:
    def test_kalman_min_ge_max_throws(self):
        # Fatal (config_fastdem.cpp:132-137).
        with pytest.raises(ValueError, match="min_variance"):
            parse_config(
                {"mapping": {"kalman": {"min_variance": 0.5,
                                        "max_variance": 0.1}}}
            )

    def test_unsorted_p2_markers_throw(self):
        # Fatal (config_fastdem.cpp:208-216).
        with pytest.raises(ValueError, match="sorted"):
            parse_config(
                {"mapping": {"p2": {"dn0": 0.9, "dn1": 0.1}}}
            )

    def test_warn_and_clamp_paths(self):
        # Non-fatal: out-of-range values clamp (config_fastdem.cpp:139-258).
        cfg = parse_config(
            {
                "mapping": {
                    "kalman": {"min_variance": -1.0},
                    "p2": {"elevation_marker": 9},
                },
                "sensor_model": {
                    "lidar": {"range_noise": -5.0},
                    "constant": {"uncertainty": 0.0},
                },
                "raycasting": {
                    "enabled": True,
                    "log_odds_max": -1.0,
                    "clear_threshold": 5.0,
                },
            }
        )
        assert cfg.mapping.kalman.min_variance == pytest.approx(0.0001)
        assert cfg.mapping.p2.elevation_marker == 4
        assert cfg.sensor_model.lidar.range_noise == pytest.approx(0.02)
        assert cfg.sensor_model.constant.uncertainty == pytest.approx(0.1)
        assert cfg.raycasting.log_odds_max == pytest.approx(2.0)
        assert cfg.raycasting.clear_threshold == pytest.approx(-1.0)

    def test_p2_dn_clamped_to_unit(self):
        cfg = parse_config({"mapping": {"p2": {"dn4": 1.5}}})
        assert cfg.mapping.p2.dn4 == pytest.approx(1.0)

    def test_raycasting_disabled_skips_its_validation(self):
        cfg = parse_config(
            {"raycasting": {"enabled": False, "log_odds_max": -1.0}}
        )
        assert cfg.raycasting.log_odds_max == pytest.approx(-1.0)


class TestPresets:
    def test_default_preset_loads(self):
        cfg = load_config("fastdem_tpu/config/presets/default.yaml")
        assert cfg.mapping.mode == MappingMode.LOCAL
        assert cfg.raycasting.enabled
        assert cfg.point_filter.range_max == pytest.approx(20.0)

    def test_global_preset(self):
        cfg = load_config("fastdem_tpu/config/presets/global_mapping.yaml")
        assert cfg.mapping.mode == MappingMode.GLOBAL
        assert not cfg.raycasting.enabled

    def test_missing_file_raises(self):
        with pytest.raises(RuntimeError, match="Failed to load config"):
            load_config("/nonexistent/config.yaml")


class TestPostProcessConfig:
    def test_parse_flat_layout(self):
        # The reference's postprocess.yaml has top-level sections.
        cfg = parse_postprocess(
            {
                "inpainting": {"enabled": True, "max_iterations": 7},
                "uncertainty_fusion": {"search_radius": 0.25},
                "feature_extraction": {"enabled": True},
            }
        )
        assert cfg.inpainting.enabled and cfg.inpainting.max_iterations == 7
        assert cfg.uncertainty_fusion.search_radius == pytest.approx(0.25)
        assert cfg.feature_extraction.enabled

    def test_nested_layout(self):
        cfg = parse_postprocess(
            {"post_processing": {"inpainting": {"enabled": True}}}
        )
        assert cfg.inpainting.enabled

    def test_preset(self):
        from fastdem_tpu.config.config import load_postprocess

        cfg = load_postprocess("fastdem_tpu/config/presets/postprocess.yaml")
        assert cfg.uncertainty_fusion.enabled
        assert not cfg.inpainting.enabled
