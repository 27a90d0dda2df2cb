"""An edge-value table and one SQL expression per scalar function and
string cast, shared by the differential tests (tests/test_torch_functions.py,
against the JAX package on the CPU) and chip_smoke.py's functions phase (the
card against the CPU).

The table (edge_table) has 16 rows of fixed edge values around seeded numpy
noise: NULLs, NaN, +-0.0, +-inf, INT64_MIN / INT64_MAX, empty and non-ASCII
strings, dates and timestamps before 1970 and at the int64 extremes. CASES
maps a case name (function and edge class) to an expression over its
columns, ERRORS the calls the reference rejects, and FAMILIES one
expression per family for a captured steady state."""
import numpy as np

I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1
US_DAY = 86_400_000_000


def edge_table(seed: int = 7) -> dict:
    """The columns: 16 rows of fixed edge values with seeded noise."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(-1000, 1000, 16)
    i = [0, 1, -1, 7, -8, 12, I64_MAX, I64_MIN, None, 36, -36, 100, 5, 20, 21, 3]
    j = [0, 0, 6, 3, 12, 18, 1, 6, 4, None, 24, I64_MIN, -5, 2, 7, I64_MAX]
    f = [0.0, -0.0, 1.5, -2.5, float("nan"), float("inf"), float("-inf"), None,
         1e300, -27.0, 0.5, 2.0, 1e-300, -1.0, float(rng.normal()), 100.0]
    g = [float(x) for x in rng.normal(0, 10, 16)]
    g[3] = None
    g[5] = 0.0
    dec = [0.0, -1.25, 3.5, None, 12345.67, -0.01, 0.01, -99.99,
           1.0, 2.5, -2.5, 0.5, -0.5, 7.77, 100.0, float(noise[0]) / 100]
    s = ["", "Apple", "banana", None, "карманный компьютер", "a,b,c", "x|y",
         "http://www.example.com/p1/q2", "https://ref1.example.org/path",
         "  pad  ", "Ünïcödé", "日本語", "hello world", "aaa", "6869", "aGk="]
    sn = ["1", "-2", "3.75", "0", "-0.0", "1e3", None, "12", "-7.5",
          "9007199254740993", "0.01", "42", " 5", "-1", "2", str(int(noise[1]))]
    sd = ["1969-12-31", "1900-01-01", "2020-02-29", "1970-01-01", None,
          "2000-12-31", "1999-05-01", "0001-01-01", "2013-07-15", "1600-03-01",
          "2038-01-19", "1969-01-01", "2100-12-31", "1970-01-02", "1960-06-15",
          "2013-07-01"]
    dt = [-1, 0, -25567, 18321, None, 10957, 59, -365, 11016, 20000, -1000,
          365, 730, 1, 31, -719162]
    ts = [0, -1, -US_DAY - 1, 1_600_000_000_123_456, -2_208_988_800_000_000,
          None, 951_782_400_000_000, I64_MIN, I64_MAX, 1_373_846_400_000_000,
          -1_000_000, 59_999_999, 60_000_000, -60_000_001,
          1_373_846_400_000_000 + int(noise[2]) * 1_000_000, 86_399_999_999]
    tm = [0, 1, 86_399_999_999, 45_296_000_000, None, 45_296_500_000,
          3_600_000_000, 59_999_999, 60_000_000, 43_200_000_001, 1_000,
          7_322_123_456, 86_340_000_000, 999_999, 1_000_000, 30_000_000]
    b = [True, False, None, True, False, True, True, False, None, False,
         True, True, False, False, True, False]
    n = [65, 97, 48, 1, 0, 255, 1000, 66, 67, 68, 13, 10, 32, 126, 127, 200]
    cols = {"k": list(range(16)), "i": i, "j": j, "f": f, "g": g, "dec": dec,
            "s": s, "sn": sn, "sd": sd, "dt": dt, "ts": ts, "tm": tm, "b": b,
            "n": n}
    return cols


def edge_types(T) -> dict:
    """The columns' types, from a types module (the port's or the JAX package's)."""
    return {"k": T.INT64, "i": T.INT64, "j": T.INT64, "f": T.FLOAT64,
            "g": T.FLOAT64, "dec": T.decimal(12, 2), "s": T.STRING,
            "sn": T.STRING, "sd": T.STRING, "dt": T.DATE32,
            "ts": T.TIMESTAMP, "tm": T.TIME, "b": T.BOOL, "n": T.INT64}


# one case per function and edge class; each is evaluated over all 16 rows
CASES = {
    # date parts: DATE32 (before 1970 too), TIMESTAMP (int64 extremes), TIME
    "extract_year_date": "extract(year FROM dt)",
    "extract_month_date": "extract(month FROM dt)",
    "extract_day_date": "extract(day FROM dt)",
    "extract_quarter_date": "extract(quarter FROM dt)",
    "extract_dow_date": "extract(dow FROM dt)",
    "extract_doy_date": "extract(doy FROM dt)",
    "year_month_day_fns": "year(dt) * 10000 + month(dt) * 100 + day(dt)",
    "extract_year_timestamp": "extract(year FROM ts)",
    "extract_month_timestamp": "extract(month FROM ts)",
    "extract_dow_timestamp": "extract(dow FROM ts)",
    "extract_hour_timestamp": "extract(hour FROM ts)",
    "extract_minute_timestamp": "extract(minute FROM ts)",
    "extract_second_timestamp": "extract(second FROM ts)",
    "date_part_minute_timestamp": "date_part('minute', ts)",
    "extract_hour_time": "extract(hour FROM tm)",
    "extract_minute_time": "extract(minute FROM tm)",
    "extract_second_time": "extract(second FROM tm)",
    "extract_millisecond_time": "extract(millisecond FROM tm)",
    "extract_microsecond_time": "extract(microsecond FROM tm)",
    # date_trunc: fixed units floor (negative timestamps), calendar units
    "date_trunc_microsecond": "CAST(date_trunc('microsecond', ts) AS BIGINT)",
    "date_trunc_millisecond": "CAST(date_trunc('millisecond', ts) AS BIGINT)",
    "date_trunc_second": "CAST(date_trunc('second', ts) AS BIGINT)",
    "date_trunc_minute": "CAST(date_trunc('minute', ts) AS BIGINT)",
    "date_trunc_hour": "CAST(date_trunc('hour', ts) AS BIGINT)",
    "date_trunc_day": "CAST(date_trunc('day', ts) AS BIGINT)",
    "date_trunc_week_ts": "CAST(date_trunc('week', ts) AS BIGINT)",
    "date_trunc_month_ts": "CAST(date_trunc('month', ts) AS BIGINT)",
    "date_trunc_quarter_ts": "CAST(date_trunc('quarter', ts) AS BIGINT)",
    "date_trunc_year_ts": "CAST(date_trunc('year', ts) AS BIGINT)",
    "date_trunc_year_date": "date_trunc('year', dt)",
    "date_trunc_quarter_date": "date_trunc('quarter', dt)",
    "date_trunc_month_date": "date_trunc('month', dt)",
    "date_trunc_week_date": "date_trunc('week', dt)",
    "date_trunc_day_date": "date_trunc('day', dt)",
    "date_bin_minutes": "CAST(date_bin(INTERVAL '15 minutes', ts) AS BIGINT)",
    "date_bin_origin": "CAST(date_bin(INTERVAL '1 hour', ts, TIMESTAMP '2001-01-01 00:30:00') AS BIGINT)",
    "date_bin_date": "CAST(date_bin(INTERVAL '2 days', dt) AS BIGINT)",
    "make_date_columns": "make_date(2024, k % 12 + 1, k + 1)",
    "make_date_literals": "make_date(1969, 2, 28)",
    "make_time_literals": "make_time(12, 34, 56.5)",
    "to_date_strings": "to_date(sd)",
    "to_time_timestamp": "to_time(ts)",
    "to_time_string": "to_time('12:34:56.25')",
    "to_timestamp_strings": "CAST(to_timestamp(sd) AS BIGINT)",
    "to_timestamp_float": "CAST(to_timestamp(g) AS BIGINT)",
    "to_timestamp_seconds_int": "CAST(to_timestamp_seconds(k * 100000 - 700000) AS BIGINT)",
    "to_timestamp_millis_int": "CAST(to_timestamp_millis(i) AS BIGINT)",
    "to_timestamp_micros_int": "CAST(to_timestamp_micros(i) AS BIGINT)",
    "to_timestamp_nanos_int": "CAST(to_timestamp_nanos(i) AS BIGINT)",
    "to_timestamp_seconds_ts": "CAST(to_timestamp_seconds(ts) AS BIGINT)",
    "to_timestamp_date": "CAST(to_timestamp(dt) AS BIGINT)",
    "from_unixtime": "CAST(from_unixtime(k * 1000000 - 5000000) AS BIGINT)",
    "to_unixtime_timestamp": "to_unixtime(ts)",
    "to_unixtime_date": "to_unixtime(dt)",
    "to_unixtime_string": "to_unixtime(sd)",
    "to_local_time": "CAST(to_local_time(ts) AS BIGINT)",
    "at_time_zone_utc": "CAST(ts AT TIME ZONE 'UTC' AS BIGINT)",
    # numbers: NaN, +-0, +-inf, extremes
    **{f"{fn}_float": f"{fn}(f)" for fn in (
        "abs", "ceil", "floor", "round", "trunc", "sqrt", "cbrt", "exp", "ln",
        "log10", "log2", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
        "cosh", "tanh", "degrees", "radians", "signum", "sign")},
    "abs_int_extremes": "abs(i)",
    "sign_int": "sign(i)",
    "ceil_decimal": "ceil(dec)",
    "floor_decimal": "floor(dec)",
    "round_decimal_2": "round(dec, 1)",
    "cbrt_negative": "cbrt(g)",
    "power": "power(f, g)",
    "pow_int": "pow(k, 2)",
    "atan2": "atan2(f, g)",
    "log_base": "log(2.0, f)",
    "log_base_columns": "log(g, f)",
    "pi": "pi() * k",
    "cot": "cot(f)",
    "nanvl": "nanvl(f, g)",
    "isnan_float": "isnan(f)",
    "isnan_int": "isnan(i)",
    "iszero_float": "iszero(f)",
    "iszero_int": "iszero(i)",
    "factorial": "factorial(i)",
    "gcd_int64_min": "gcd(i, j)",
    "lcm_int64_min": "lcm(i, j)",
    "gcd_literals": "gcd(-9223372036854775807 - 1, 6)",
    "greatest_int_null": "greatest(i, j)",
    "least_int_null": "least(i, j)",
    "greatest_mixed": "greatest(k, f, 3)",
    "least_float_null": "least(f, g)",
    "greatest_string": "greatest(s, 'm')",
    "least_string_null": "least(s, sn)",
    "nvl_int": "nvl(i, j)",
    "ifnull_string": "ifnull(s, '<null>')",
    "nvl2_mixed": "nvl2(i, f, k)",
    "nvl2_string": "nvl2(g, s, 'none')",
    "coalesce_mixed": "coalesce(i, j, 0)",
    "nullif_string": "nullif(s, 'aaa')",
    "chr_literal": "chr(65)",
    "chr_bounded": "chr(n)",
    "char_bounded": "char(n)",
    "to_hex_bounded": "to_hex(n)",
    "arrow_typeof_int": "arrow_typeof(i)",
    "arrow_typeof_decimal": "arrow_typeof(dec)",
    "arrow_typeof_date": "arrow_typeof(dt)",
    "arrow_cast_int32": "arrow_cast(k, 'Int32')",
    "arrow_cast_null_utf8": "arrow_cast(NULL, 'Utf8')",
    "version": "version()",
    # strings: NULL, empty, non-ASCII
    **{f"{fn}_strings": f"{fn}(s)" for fn in (
        "length", "char_length", "character_length", "octet_length", "ascii",
        "upper", "lower", "trim", "ltrim", "rtrim", "btrim", "initcap",
        "reverse", "md5", "sha224", "sha256", "sha384", "sha512")},
    "strpos": "strpos(s, 'a')",
    "strpos_non_ascii": "strpos(s, 'компьютер')",
    "position": "position(s, 'a')",
    "starts_with": "starts_with(s, 'a')",
    "ends_with": "ends_with(s, 'a')",
    "contains": "contains(s, 'an')",
    "left": "left(s, 3)",
    "right": "right(s, 2)",
    "right_zero": "right(s, 0)",
    "replace": "replace(s, 'a', 'XY')",
    "translate": "translate(s, 'ab', 'c')",
    "lpad": "lpad(s, 8, '*')",
    "lpad_default": "lpad(s, 3)",
    "rpad": "rpad(s, 8, '-=')",
    "repeat": "repeat(s, 2)",
    "split_part": "split_part(s, ',', 2)",
    "split_part_negative": "split_part(s, '.', -1)",
    "substr_index": "substr_index(s, '.', 2)",
    "substring_index_negative": "substring_index(s, '/', -2)",
    "overlay": "overlay(s, 'XY', 2)",
    "overlay_count": "overlay(s, 'XY', 2, 4)",
    "substr": "substr(s, 2, 3)",
    "concat": "concat(s, '-', sn)",
    "concat_ws_nulls": "concat_ws(',', s, 'x', sn)",
    "concat_ws_null_sep": "concat_ws(NULL, s, 'x')",
    "regexp_replace_clickbench": r"regexp_replace(s, '^https?://(?:www\.)?([^/]+)/.*$', '\\1')",
    "regexp_replace_class": "regexp_replace(s, '[aeiou]', '_')",
    "regexp_like": "regexp_like(s, '^[a-z]+$')",
    "regexp_match": "regexp_match(s, 'a.a')",
    "regexp_count": "regexp_count(s, '[a-c]')",
    "regexp_instr": "regexp_instr(s, 'n+')",
    "encode_hex": "encode(s, 'hex')",
    "encode_base64": "encode(s, 'base64')",
    "decode_hex": "decode(s, 'hex')",
    "decode_base64": "decode(s, 'base64')",
    "find_in_set": "find_in_set(s, 'Apple,banana,,aaa')",
    # casts to and from strings
    "cast_string_to_bigint": "CAST(sn AS BIGINT)",
    "cast_string_to_int": "CAST(sn AS INT)",
    "cast_string_to_double": "CAST(sn AS DOUBLE)",
    "cast_string_to_decimal": "CAST(sn AS DECIMAL(10, 2))",
    "cast_literal_to_bigint": "CAST('12' AS BIGINT)",
    "cast_utf8_to_binary": "arrow_cast(s, 'Binary')",
    "cast_binary_to_utf8": "arrow_cast(arrow_cast(s, 'Binary'), 'Utf8')",
    "cast_invalid_binary_to_utf8": "arrow_cast(X'FF61', 'Utf8')",
    "cast_bigint_to_string_extremes": "CAST(i AS VARCHAR)",
    "cast_double_to_string_nan_zero": "CAST(f AS VARCHAR)",
    "cast_decimal_to_string": "CAST(dec AS VARCHAR)",
    "cast_bool_to_string": "CAST(b AS VARCHAR)",
    "cast_date_to_string_before_1970": "CAST(dt AS VARCHAR)",
    "cast_timestamp_to_string": "CAST(ts AS VARCHAR)",
    "cast_time_to_string": "CAST(tm AS VARCHAR)",
    "cast_expression_to_string": "CAST(k * 3 - 20 AS VARCHAR) || '!'",
    "to_char_date": "to_char(dt, '%Y/%m/%d %a')",
    "to_char_string": "to_char(s, '%Y')",
}

# the reference rejects these: the port must raise the same class
ERRORS = {
    "random": "random()",
    "bit_length": "bit_length(s)",
    "levenshtein": "levenshtein(s, 'a')",
    "log_one_argument": "log(f)",
    "make_time_column": "make_time(k, 1, 1)",
    "make_time_out_of_range": "make_time(24, 0, 0)",
    "chr_unbounded": "chr(i)",
    "date_trunc_unknown_unit": "date_trunc('fortnight', ts)",
    "date_trunc_time": "date_trunc('hour', tm)",
    "extract_hour_of_date": "extract(hour FROM dt)",
    "extract_unknown_time_part": "extract(year FROM tm)",
    "date_bin_negative_stride": "date_bin(INTERVAL '-1 minute', ts)",
    "at_time_zone_other": "ts AT TIME ZONE 'Europe/Paris'",
    "cast_string_not_a_number": "CAST(s AS BIGINT)",
    "cast_binary_to_number": "CAST(arrow_cast(s, 'Binary') AS BIGINT)",
    "string_function_on_binary": "upper(arrow_cast(s, 'Binary'))",
    "to_char_of_a_number": "to_char(k, '%Y')",
    "arrow_cast_unknown_type": "arrow_cast(k, 'Quaternion')",
}


FAMILIES = {
    "date_parts": "extract(minute FROM ts) + extract(doy FROM dt) + extract(hour FROM tm)",
    "date_trunc": "CAST(date_trunc('minute', ts) AS BIGINT) + CAST(date_trunc('month', dt) AS BIGINT)",
    "clock": "CAST(now() AS BIGINT) - CAST(now() AS BIGINT)",
    "numbers": "cbrt(f) + atan2(f, g) + gcd(i, j) + factorial(i) + greatest(i, j)",
    "string_lookups": "length(s) + strpos(s, 'a') + regexp_count(s, 'a')",
    "string_transforms": "concat_ws('|', regexp_replace(s, 'a', 'b'), md5(sn), lpad(s, 4, '*'))",
    "int_to_string": "to_hex(n) || chr(65)",
    "casts": "CAST(sn AS DOUBLE) + length(CAST(f AS VARCHAR) || CAST(dt AS VARCHAR))",
}
