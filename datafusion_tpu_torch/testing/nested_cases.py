"""The nested-type case table: list, struct and map queries over small
tables, shared by the differential tests (tests/test_torch_nested.py,
against the JAX package on the CPU) and chip_smoke.py's nested phase (the
card against the CPU); and the TPC-H queries N1-N8 that the nested phase
runs at scale.

TABLES are the tables every case reads (pydict columns: lists with NULL
elements, empty and NULL lists, structs and maps with NULL rows and
fields; `u` is 300 seeded random lists). CASES maps a case name to one
SQL query, ERRORS the queries the reference rejects, FAMILIES one query per
function family for a captured steady state, and TPCH the queries N1-N8
over TPC-H's orders, lineitem, customer and part."""
import numpy as np

# structs and maps with NULL rows and NULL fields
ROWS_S = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}, None, {"a": 1, "b": "x"},
          {"a": 5, "b": None}]
ROWS_M = [{"k1": 10, "k2": 20}, {"k1": 5}, {"k3": 7}, None, {"k1": 1, "k9": 9}]


def tables(seed: int = 9) -> dict:
    """name -> pydict of columns."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 50, rng.integers(0, 5)).tolist() for _ in range(300)]
    return {
        "t": {"k": [1, 2, 3, 4], "s": ["a,b", "c", None, "d,e,f"],
              "arr": [[10, 20], [], None, [30]],
              "strs": [["x", "y"], ["y"], None, []]},
        "g": {"k": [1, 1, 2, 2, 2, 3], "v": [10, 20, 30, None, 50, 60],
              "s": ["a", "b", "c", "d", "e", "f"]},
        "g2": {"k": [1, 1, 2], "v": [10, 20, 30]},
        "u": {"k": list(range(300)), "a": rows},
        "lam_t": {"id": [1, 2], "m": [5, 10]},
        "lam_s": {"x": [100], "arr_src": [1]},
        "sm": {"s": ROWS_S, "m": ROWS_M, "v": [1.0, 2.0, 3.0, 4.0, 5.0]},
    }


CASES = {
    # lists: construction, access, membership
    "array_literal": "SELECT [1, 2, k] a FROM t WHERE k = 2",
    "make_array": "SELECT make_array(k, k*2) m FROM t WHERE k = 3",
    "array_literal_strings": "SELECT ['p', s] m FROM t WHERE k = 2",
    "element_length": "SELECT arr[1] e1, arr[-1] em, arr[5] oob, array_length(arr) n, "
                      "cardinality(arr) c, empty(arr) emp FROM t",
    "membership": "SELECT array_has(arr, 20) h, array_position(arr, 30) p, "
                  "array_has_all(arr, [10, 20]) ha, array_has_any(arr, [99, 20]) hy "
                  "FROM t",
    "membership_strings": "SELECT array_has(strs, 'y') h, array_position(strs, 'y') p, "
                          "array_has_any(strs, ['q', 'x']) a FROM t",
    "append_prepend_concat": "SELECT array_append(arr, 99) ap, array_prepend(0, arr) pre, "
                             "array_concat(arr, [7, 8]) cc FROM t WHERE k IN (1, 2)",
    "append_strings": "SELECT array_concat(strs, ['zz']) a, array_append(strs, 'q') b, "
                      "array_prepend('q', strs) c FROM t",
    "slice_reverse_pop": "SELECT array_slice([1,2,3,4,5], 2, 4) sl, "
                         "array_slice([1,2,3,4,5], -2, -1) sn, "
                         "array_reverse(arr) rv, array_pop_back([1,2,3]) pb, "
                         "array_pop_front([1,2,3]) pf FROM t WHERE k = 1",
    "sort_distinct": "SELECT array_sort([3,1,2]) s, array_sort([3,1,2], 'desc') sd, "
                     "array_distinct([2,1,2,3,1]) d FROM t WHERE k = 1",
    "set_ops": "SELECT array_union([1,2], [2,3]) u, array_intersect([1,2,3], [2,3,9]) i, "
               "array_except([1,2,3], [2]) x FROM t WHERE k = 1",
    "set_ops_strings": "SELECT array_union(strs, ['z', 'x']) u, "
                       "array_intersect(strs, ['y']) i, array_except(strs, ['y']) e, "
                       "array_sort(strs, 'desc') s FROM t",
    "remove_repeat_resize": "SELECT array_remove([1,2,2,3,2], 2) r1, "
                            "array_remove_n([1,2,2,3,2], 2, 2) r2, "
                            "array_remove_all([1,2,2,3,2], 2) ra, "
                            "array_repeat(7, 3) rp, array_resize([1,2], 4, 0) rs "
                            "FROM t WHERE k = 1",
    "reductions": "SELECT array_min(arr) mn, array_max(arr) mx, array_sum(arr) sm, "
                  "array_mean(arr) av, array_any_value(arr) anyv FROM t",
    "positions_dims": "SELECT array_positions([1,2,1,3,1], 1) p, array_dims(arr) d, "
                      "array_ndims(arr) nd, array_element(arr, k) e FROM t",
    "string_to_array": "SELECT string_to_array(s, ',') sp FROM t",
    "range": "SELECT range(1, 7, 2) r, range(3) r0 FROM t WHERE k = 1",
    "concat_ws_array": "SELECT concat_ws('-', make_array('a', 'b'), s) c FROM t",
    # unnest
    "unnest": "SELECT k, unnest(arr) v FROM t",
    "unnest_string_to_array": "SELECT k, unnest(string_to_array(s, ',')) p FROM t",
    "unnest_zip": "SELECT k, unnest(arr) a, unnest(strs) b FROM t",
    "unnest_aggregate": "SELECT sum(u) su, count(*) c FROM (SELECT unnest(arr) u FROM t)",
    "unnest_group": "SELECT p, count(*) c FROM "
                    "(SELECT unnest(string_to_array(s, ',')) p FROM t) "
                    "GROUP BY p ORDER BY p",
    "unnest_topk": "SELECT k, unnest(arr) v FROM t ORDER BY v DESC LIMIT 2",
    "unnest_explode": "SELECT k, unnest(a) v FROM u",
    # lists through joins and UNION
    "lists_through_join": "SELECT a.k, b.arr FROM t a JOIN t b ON a.k = b.k "
                          "WHERE a.k <= 2 ORDER BY a.k",
    "lists_through_left_join": "SELECT a.k, b.arr FROM t a LEFT JOIN t b "
                               "ON a.k = b.k + 1 ORDER BY a.k",
    "lists_through_union": "SELECT arr FROM t WHERE k = 1 UNION ALL "
                           "SELECT arr FROM t WHERE k = 4",
    # array_agg and string_agg
    "array_agg_grouped": "SELECT k, array_agg(v) vs FROM g GROUP BY k ORDER BY k",
    "array_agg_grouped_strings": "SELECT k, array_agg(s) ss FROM g GROUP BY k ORDER BY k",
    "array_agg_two": "SELECT k, array_agg(v) a, array_agg(s) b, count(*) c FROM g "
                     "GROUP BY k ORDER BY k",
    "array_agg_order_by": "SELECT k, array_agg(v ORDER BY v DESC) x FROM g "
                          "GROUP BY k ORDER BY k",
    "array_agg_functions": "SELECT k, array_length(array_agg(v)) n, "
                           "array_max(array_agg(v)) mx, array_has(array_agg(s), 'd') h "
                           "FROM g GROUP BY k ORDER BY k",
    "array_agg_global": "SELECT array_agg(k) ks FROM g2",
    "array_agg_empty": "SELECT array_agg(v) e FROM g2 WHERE k > 99",
    "unnest_array_agg": "SELECT sum(u) su FROM (SELECT unnest(array_agg(v)) u FROM g2)",
    "string_agg_grouped": "SELECT k, string_agg(s, '|') x FROM g GROUP BY k ORDER BY k",
    "string_agg_global": "SELECT string_agg(s, '|') x FROM g",
    "string_agg_distinct": "SELECT k, string_agg(DISTINCT s, ',') x FROM g "
                           "GROUP BY k ORDER BY k",
    "string_agg_filter": "SELECT k, string_agg(s, ',') FILTER (WHERE v > 20) x FROM g "
                         "GROUP BY k ORDER BY k",
    # lambda functions
    "transform": "SELECT array_transform(make_array(1,2,3), x -> x * 2) a",
    "transform_index": "SELECT array_transform(make_array(10,20), (x, i) -> x + i) a",
    "transform_capture": "SELECT array_transform(make_array(1,2), x -> x * m) a "
                         "FROM lam_t ORDER BY id",
    "transform_strings": "SELECT list_transform(string_to_array('a,b', ','), "
                         "s -> upper(s)) a",
    "filter": "SELECT array_filter(make_array(1,2,3,4), x -> x % 2 = 0) a",
    "filter_strings": "SELECT array_filter(make_array('aa','b','cc'), "
                      "s -> length(s) = 2) a",
    "any_all_match": "SELECT array_any_match(make_array(1,2,3), x -> x > 2) a, "
                     "array_all_match(make_array(1,2,3), x -> x > 0) b, "
                     "array_any_match(make_array(1,2), x -> x > 5) c, "
                     "array_all_match(make_array(1,2), x -> x > 1) d",
    "lambda_shadows_column": "SELECT array_transform(make_array(1,2), x -> x + 1) a "
                             "FROM lam_s",
    "lambda_null_3vl": "SELECT array_any_match(make_array(1, NULL), x -> x > 5) a, "
                       "array_any_match(make_array(1, NULL), x -> x > 0) b, "
                       "array_all_match(make_array(1, NULL), x -> x > 0) c, "
                       "array_all_match(make_array(1, NULL), x -> x > 5) d",
    "lambda_null_elements": "SELECT array_transform(make_array(1, NULL, 3), x -> x + 1) a, "
                            "array_filter(make_array(1, NULL, 3), x -> x > 0) b",
    "lambda_over_column": "SELECT k, array_any_match(arr, x -> x > k * 10) a, "
                          "array_all_match(arr, x -> x >= 10) b FROM t",
    # structs and maps
    "get_field": "SELECT s['a'] a, s['b'] b, get_field(s, 'a') ga FROM sm",
    "map_functions": "SELECT m['k1'] k1, element_at(m, 'k1') e1, map_keys(m) mk, "
                     "map_values(m) mv, cardinality(m) c, map_contains_key(m, 'k1') h, "
                     "map_extract(m, 'k2') me FROM sm",
    "map_entries": "SELECT map_entries(m) e FROM sm",
    "struct_group_sort": "SELECT s, count(*) c FROM sm GROUP BY s "
                         "ORDER BY c DESC, s['a']",
    "struct_count_distinct": "SELECT count(DISTINCT s) n FROM sm",
    "constructors": "SELECT named_struct('x', 7, 'y', 'hi')['x'] nx, "
                    "struct(1, 'two')['c1'] s1, map(['a','b'], [10, 20])['b'] mb, "
                    "make_map('p', 1, 'q', 2)['q'] mq FROM sm LIMIT 1",
    "struct_filter": "SELECT v FROM sm WHERE s['a'] = 1 ORDER BY v",
}

# queries the reference rejects (list keys; a struct built from a column)
ERRORS = {
    "group_by_list": "SELECT arr, count(*) FROM t GROUP BY arr",
    "order_by_list": "SELECT * FROM t ORDER BY arr",
    "distinct_list": "SELECT DISTINCT arr FROM t",
    "struct_from_column": "SELECT named_struct('a', v) FROM sm",
}

# one query per family, for a steady state captured with no host sync
FAMILIES = {
    "access": "SELECT k, arr[1] e, array_length(arr) n, array_has(arr, 20) h, "
              "array_position(strs, 'y') p FROM t",
    "reshape": "SELECT k, array_append(arr, 99) ap, array_concat(strs, ['zz']) cc, "
               "array_slice(arr, 1, 1) sl, array_reverse(arr) rv FROM t",
    "sort_set": "SELECT k, array_sort(arr, 'desc') s, array_distinct(array_concat(arr, arr)) d, "
                "array_union(strs, ['z', 'x']) u, array_intersect(strs, ['y']) i FROM t",
    "reduce": "SELECT k, array_min(arr) mn, array_sum(arr) sm, array_mean(arr) av FROM t",
    "string_to_array": "SELECT k, string_to_array(s, ',') sp FROM t",
    "lambda": "SELECT k, array_filter(arr, x -> x > 10) f, array_transform(arr, x -> x * k) t, "
              "array_any_match(arr, x -> x > k * 10) a FROM t",
    "unnest": "SELECT k, unnest(arr) a, unnest(strs) b FROM t",
    "array_agg": "SELECT k, array_agg(v) a, array_agg(s) b FROM g GROUP BY k",
    "string_agg": "SELECT k, string_agg(s, ',') x, string_agg(DISTINCT s, '|') y FROM g "
                  "GROUP BY k",
    "global_agg": "SELECT array_agg(v) a, string_agg(s, ',') x FROM g",
    "struct_map": "SELECT s['a'] a, m['k1'] k1, map_keys(m) mk, cardinality(m) c, "
                  "map_extract(m, 'k2') me, named_struct('x', 7)['x'] nx FROM sm",
}

# over TPC-H's tables: the grouped and global list aggregates, unnest, the
# word count, lambdas and set functions over aggregated lists
TPCH = {
    "N1": "select o_custkey, array_agg(o_orderkey) os from orders group by o_custkey",
    "N2": "select o_custkey, array_length(array_agg(o_orderkey)) n, "
          "array_max(array_agg(o_totalprice)) mx, "
          "array_has(array_agg(o_orderpriority), '1-URGENT') urgent "
          "from orders group by o_custkey",
    "N3": "select o_custkey, unnest(os) o_orderkey from (select o_custkey, "
          "array_agg(o_orderkey) os from orders group by o_custkey)",
    "N4": "select l_orderkey, array_agg(l_partkey) ps, array_agg(l_quantity) qs "
          "from lineitem group by l_orderkey",
    "N5": "select c_nationkey, string_agg(c_mktsegment, ',') segs from customer "
          "group by c_nationkey",
    "N6": "select w, count(*) c from (select unnest(string_to_array(p_name, ' ')) w "
          "from part) group by w",
    "N7": "select o_custkey, array_filter(array_agg(o_orderkey), x -> x % 2 = 0) ev, "
          "array_transform(array_agg(o_totalprice), x -> x * 2) dbl "
          "from orders group by o_custkey",
    "N8": "select o_custkey, array_sort(array_distinct(array_agg(o_orderpriority))) ps, "
          "array_intersect(array_agg(o_orderkey % 10), array_agg(o_orderkey % 7)) i "
          "from orders group by o_custkey",
}
